"""Mean host time from a call's entry to its return, before the caller
reads its info, in ms. Near the call's whole time it says that the host,
or a wait inside the call, sets the pace."""


def read(run):
    s = run.window.host_s
    return 1e3 * sum(s) / len(s) if s else None
