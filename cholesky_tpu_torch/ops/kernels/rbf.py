"""The GP model's RBF kernel on the card (csrc/rbf.cu), each beside its
plain torch twin:

- rbf_f32: K[i, j] = amp·exp(−0.5·D[i, j] / ell2) for X1 (n, d) and X2
  (m, d), D the squared distances in the JAX package's difference form;
  given log_noise, (noise + jitter) is added on the diagonal (X2 is X1);
- rbf_grad_f32: the gradients of the NLL in (log_amp, log_len, log_noise),
  ½·Σᵢⱼ Wᵢⱼ·(∂K/∂θ)ᵢⱼ with W = K⁻¹ − ααᵀ, from the lower triangle of K⁻¹,
  α and X alone.

Neither replaces a TPU kernel: the JAX model (``cholesky_tpu/models/
gp.py``) leaves these passes to XLA, while eager torch wrote each n × n
intermediate to device memory. amp = exp(2·log_amp), ell2 = exp(2·log_len)
and noise = exp(2·log_noise) are computed by the kernels from the 0-d
parameter tensors, so nothing is read back to the host. A CPU tensor takes
the twin; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cholesky_tpu_torch.ops.kernels import _build
from cholesky_tpu_torch.utils.errors import check

#: the tile edge (csrc/rbf.cu)
TILE = 64
#: rbf_grad_f32's blocks: three on each of the H100's 132 SMs
#: (__launch_bounds__(256, 3)), each walking the lower tiles in a fixed
#: order, so a call's sums do not depend on the card's state
GRAD_BLOCKS = 3 * 132


def sqdist_plain(X1, X2):
    """Squared distances in the difference form of the JAX package, which
    rounds as it does, accumulated one feature at a time so that no
    (n, m, d) temporary is made."""
    D = torch.zeros((X1.shape[0], X2.shape[0]), dtype=X1.dtype,
                    device=X1.device)
    for f in range(X1.shape[1]):
        d = X1[:, f, None] - X2[None, :, f]
        D += d * d
    return D


def rbf_plain(X1, X2, log_amp, log_len, log_noise=None, jitter=0.0):
    """The plain torch version, any dtype and device."""
    amp = torch.exp(2.0 * log_amp)
    ell2 = torch.exp(2.0 * log_len)
    K = amp * torch.exp(-0.5 * sqdist_plain(X1, X2) / ell2)
    if log_noise is not None:
        K.diagonal().add_(torch.exp(2.0 * log_noise) + jitter)
    return K


def rbf_grad_plain(Kinv_tri, alpha, X, log_amp, log_len, log_noise):
    """The plain torch version, any dtype and device: the kernel's sums
    over the lower triangle, each entry below the diagonal counted twice
    for itself and its mirror. Nothing above the diagonal of Kinv_tri is
    read. Returns (g_amp, g_len, g_noise), 0-d tensors."""
    n = X.shape[0]
    amp = torch.exp(2.0 * log_amp)
    ell2 = torch.exp(2.0 * log_len)
    noise = torch.exp(2.0 * log_noise)
    D = sqdist_plain(X, X)
    Kf = amp * torch.exp(-0.5 * D / ell2)
    W = torch.tril(Kinv_tri) - alpha[:, None] * alpha[None, :]
    low = torch.ones((n, n), dtype=torch.bool, device=X.device).tril_(-1)
    weight = torch.where(low, 2.0, 0.0).to(X.dtype)
    weight.diagonal().fill_(1.0)
    g_amp = 0.5 * torch.sum(weight * (W * (2.0 * Kf)))
    g_len = 0.5 * torch.sum(weight * (W * (Kf * (D / ell2))))
    g_noise = 0.5 * torch.trace(W) * 2.0 * noise
    return g_amp, g_len, g_noise


def _check_params(name, X, params):
    for p in params:
        check(p.ndim == 0 and p.dtype == torch.float32
              and p.device == X.device, name, 3,
              "the parameters must be 0-d float32 tensors on the device of "
              "X")


def _check_points(name, *Xs):
    for X in Xs:
        check(X.ndim == 2, name, 1, "the points must be 2-D")
        check(X.dtype == torch.float32, name, 1, "float32 points only")
        check(X.device == Xs[0].device, name, 1,
              "the points on different devices")
        check(X.shape[1] == Xs[0].shape[1], name, 1,
              f"feature counts {X.shape[1]} and {Xs[0].shape[1]} differ")
    check(Xs[0].device.type in ("cpu", "cuda"), name, 1,
          f"unsupported device {Xs[0].device}")


def _launch_rbf(X1, X2, params, log_noise, jitter, raw):
    """K (or D with ``raw``) from one launch; X2 is X1 takes the lower
    tiles and their mirrors."""
    sym = X2 is X1
    X1 = X1.contiguous()
    X2 = X1 if sym else X2.contiguous()
    n, d = X1.shape
    m = X2.shape[0]
    K = torch.empty((n, m), dtype=torch.float32, device=X1.device)
    if n and m:
        ptrs = [p.data_ptr() if p is not None else None
                for p in (*params, log_noise)]
        _build.launch("rbf_f32", X1.data_ptr(), n, X2.data_ptr(), m, d,
                      *ptrs, float(jitter), int(raw), K.data_ptr(), m,
                      *_build.device_args(K))
        rbf_f32.launches += 1
    return K


def _rbf_shape(X1, X2, *args, **kwargs):
    return {"n": X1.shape[0], "m": X2.shape[0], "d": X1.shape[1],
            "dtype": _build.dtype_name(X1), "sym": X2 is X1}


@_build.kernel_span("rbf_f32", _rbf_shape)
def rbf_f32(X1, X2, log_amp, log_len, log_noise=None, jitter=0.0):
    """The RBF kernel matrix K (n, m), f32, of the points X1 (n, d) and X2
    (m, d) under 0-d f32 log_amp and log_len on their device; with
    log_noise (X2 must be X1) the diagonal gains noise + ``jitter``."""
    _check_points("rbf_f32", X1, X2)
    _check_params("rbf_f32", X1, [log_amp, log_len]
                  + ([log_noise] if log_noise is not None else []))
    check(log_noise is None or X2 is X1, "rbf_f32", 5,
          "the diagonal term needs X2 to be X1")
    if X1.device.type == "cpu":
        return rbf_plain(X1, X2, log_amp, log_len, log_noise, jitter)
    return _launch_rbf(X1, X2, (log_amp, log_len), log_noise, jitter, False)


@_build.kernel_span("rbf_f32", _rbf_shape)
def sqdist_f32(X1, X2):
    """The squared distances D (n, m) of rbf_f32, from the same kernel in
    the mode that writes D: bit for bit :func:`sqdist_plain`'s. A launch
    counts under rbf_f32."""
    _check_points("sqdist_f32", X1, X2)
    if X1.device.type == "cpu":
        return sqdist_plain(X1, X2)
    return _launch_rbf(X1, X2, (None, None), None, 0.0, True)


def _grad_shape(Kinv_tri, alpha, X, *args, **kwargs):
    return {"n": X.shape[0], "d": X.shape[1], "dtype": _build.dtype_name(X)}


@_build.kernel_span("rbf_grad_f32", _grad_shape)
def rbf_grad_f32(Kinv_tri, alpha, X, log_amp, log_len, log_noise):
    """(g_amp, g_len, g_noise), 0-d f32 tensors on the device of X, from
    the lower triangle of Kinv_tri (n, n; nothing above the diagonal is
    read), alpha = K⁻¹y (n,) and the points X (n, d). Two launches on the
    card: the blocks' partial sums, then their sum in a fixed order."""
    _check_points("rbf_grad_f32", X)
    n = X.shape[0]
    check(Kinv_tri.shape == (n, n) and alpha.shape == (n,), "rbf_grad_f32",
          1, f"Kinv_tri {tuple(Kinv_tri.shape)} and alpha "
          f"{tuple(alpha.shape)} do not fit X {tuple(X.shape)}")
    check(Kinv_tri.dtype == alpha.dtype == torch.float32
          and Kinv_tri.device == alpha.device == X.device, "rbf_grad_f32", 1,
          "Kinv_tri and alpha must be float32 on the device of X")
    _check_params("rbf_grad_f32", X, [log_amp, log_len, log_noise])
    if X.device.type == "cpu":
        return rbf_grad_plain(Kinv_tri, alpha, X, log_amp, log_len,
                              log_noise)
    out = (torch.empty if n else torch.zeros)((3,), dtype=torch.float32,
                                              device=X.device)
    if n:
        if Kinv_tri.stride(1) != 1 or Kinv_tri.stride(0) < n:
            Kinv_tri = Kinv_tri.contiguous()
        X, alpha = X.contiguous(), alpha.contiguous()
        tiles = -(-n // TILE)
        blocks = min(tiles * (tiles + 1) // 2, GRAD_BLOCKS)
        partials = torch.empty((3 * blocks,), dtype=torch.float32,
                               device=X.device)
        _build.launch("rbf_grad_f32", Kinv_tri.data_ptr(),
                      Kinv_tri.stride(0), alpha.data_ptr(), X.data_ptr(), n,
                      X.shape[1], log_amp.data_ptr(), log_len.data_ptr(),
                      log_noise.data_ptr(), blocks, partials.data_ptr(),
                      out.data_ptr(), *_build.device_args(X))
        rbf_grad_f32.launches += 1
    return out[0], out[1], out[2]


rbf_f32.launches = 0
rbf_grad_f32.launches = 0
