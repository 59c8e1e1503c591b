"""The one generator of every traffic mix: ``workloads/<traffic>.json``
holds parameters, and this turns them into the order of calls.

Keys a mix may hold:

- ``call``: the entry point the cell drives, ``calls/<call>.py``;
- ``sizes``: the matrix orders, a list or ``{"from", "to", "step"}``;
  calls cycle through them in that order, one call each (a mix without
  it takes the configuration's ``n``);
- ``pool``: how many distinct inputs of one size set-up makes, cycled
  through in order (test sets of a predict call);
- ``warm``: set-up calls on each input before the window;
- ``sample``: how many of the window's answers the check compares, drawn
  from the seed;
- ``first_steps``: set-up steps of a training call that the reference
  follows.
"""


def sizes(traffic, config):
    spec = traffic.get("sizes", [config.get("n")])
    if isinstance(spec, dict):
        return list(range(spec["from"], spec["to"] + 1, spec["step"]))
    return list(spec)


def pick(i, count):
    """The input of call i when calls cycle through ``count`` inputs."""
    return i % count
