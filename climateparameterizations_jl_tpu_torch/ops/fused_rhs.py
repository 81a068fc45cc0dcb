"""Fused wind-mixing RHS + multi-step RK4: the serving path's kernel.

Port of ``climateparameterizations_jl_tpu/ops/fused_rhs.py``. The JAX
package runs a whole RK4 trajectory segment inside one Pallas TPU kernel
(two variants: ``make_fused_runner_mxu`` and ``make_fused_runner``). Here
both runners launch the hand-written CUDA kernel ``csrc/fused_rk4.cu``
(``ops/_cuda.py``) for CUDA tensors; ``make_fused_runner_mxu(...,
matmul_dtype="bfloat16")`` launches ``csrc/fused_rk4_bf16.cu``, whose three
NN products run on the tensor cores. For CPU tensors the runners run the
kernels' plain PyTorch version, :func:`_multistep_plain` (RK4 over
:func:`_make_mxu_rhs`). There is no fallback from a kernel to the plain
version.

The host-side constant builders (:func:`_pack_block_weights`,
:func:`_scalar_constants`, :func:`divergence_matrix`, ...) are numpy, as in
the JAX package, and give the same arrays to the bit.

Scope, as the TPU kernels: non-diurnal, mPP + ``zero_weights``, no
smoothing, forward only. ``column_block`` and ``loop_unroll`` are the TPU's
tiling knobs; they are accepted so that callers carry over and do not
change the result.
"""

from __future__ import annotations

import numpy as np
import torch

from climateparameterizations_jl_tpu_torch.closures.mlp import mish
from climateparameterizations_jl_tpu_torch.device import resolve_device
from climateparameterizations_jl_tpu_torch.ops import _cuda


def _np(a, dtype):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _pack_block_weights(nns, Nz: int, dtype=np.float32, pad_to_block: bool = False):
    """Pack the three flux MLPs into right-multiply block matrices.

    Returns ``(A1, b1, A2, b2, A3, b3), (h1, h2, n_out)`` with ``A1 (3Nz,
    3h1)``, block-diagonal ``A2 (3h1, 3h2)`` / ``A3`` and ``(1, n)`` bias
    rows. ``pad_to_block=False`` gives the compact ``(C, 3 (Nz-1))`` last
    layer; ``pad_to_block=True`` the block-aligned ``(C, 3 Nz)`` layout
    (block ``b`` in lanes ``[b Nz, (b+1) Nz)``, a structural zero in the
    seam lane).
    """
    mlps = [nns.uw, nns.vw, nns.wT]
    h1 = mlps[0].weights[0].shape[0]
    h2 = mlps[0].weights[1].shape[0]
    n_out = mlps[0].weights[2].shape[0]
    if n_out != Nz - 1:
        raise ValueError("flux MLPs must output Nz-1 interior faces")
    stride = Nz if pad_to_block else n_out

    A1 = np.concatenate([_np(m.weights[0], dtype).T for m in mlps], axis=1)  # (3Nz, 3h1)
    b1 = np.concatenate([_np(m.biases[0], dtype) for m in mlps])[None, :]
    A2 = np.zeros((3 * h1, 3 * h2), dtype)
    b2 = np.concatenate([_np(m.biases[1], dtype) for m in mlps])[None, :]
    A3 = np.zeros((3 * h2, 3 * stride), dtype)
    b3 = np.zeros((1, 3 * stride), dtype)
    for i, m in enumerate(mlps):
        A2[i * h1 : (i + 1) * h1, i * h2 : (i + 1) * h2] = _np(m.weights[1], dtype).T
        A3[i * h2 : (i + 1) * h2, i * stride : i * stride + n_out] = _np(m.weights[2], dtype).T
        b3[0, i * stride : i * stride + n_out] = _np(m.biases[2], dtype)
    return (A1, b1, A2, b2, A3, b3), (h1, h2, n_out)


def _resolve_activation(activation: str):
    """Map the MLP activation name to its torch form; raise on unsupported."""
    if activation == "mish":
        return mish
    if activation == "relu":
        return torch.relu
    raise NotImplementedError(
        f"fused RHS paths support activation 'mish' or 'relu', got {activation!r}; "
        "use the plain path (wind_mixing_rhs) for other activations"
    )


def _assert_fused_config(model):
    """The configuration every fused/fast path implements (and nothing else)."""
    if model.diurnal:
        raise ValueError("fused kernels cover the non-diurnal configuration")
    if not (model.use_mpp and model.zero_weights):
        raise ValueError("fused kernels implement the mPP + zero_weights flux path")
    if model.smooth_NN or model.smooth_Ri:
        raise ValueError(
            "fused kernels do not apply the NN/Ri smoothing filters; use the plain path (wind_mixing_rhs)"
        )


def _scalar_constants(model, bcs=None) -> tuple:
    """The scalar tuple that parameterizes the RHS (``bcs=None`` zeroes the BC tail)."""
    s = model.scalings
    Hga = float(model.H) * float(model.g) * float(model.alpha)
    z_u = (0.0 - float(s.uw.mu)) / float(s.uw.sigma)
    z_v = (0.0 - float(s.vw.mu)) / float(s.vw.sigma)
    z_T = (0.0 - float(s.wT.mu)) / float(s.wT.sigma)
    if bcs is None:
        bc_tail = (0.0,) * 6
    else:
        bc_tail = (
            float(bcs.uw_bot) - z_u, float(bcs.uw_top) - z_u,
            float(bcs.vw_bot) - z_v, float(bcs.vw_top) - z_v,
            float(bcs.wT_bot) - z_T, float(bcs.wT_top) - z_T,
        )
    return (
        Hga,
        float(s.u.sigma), float(s.v.sigma), float(s.T.sigma),
        float(s.u.mu), float(s.v.mu),
        float(s.uw.sigma), float(s.vw.sigma), float(s.wT.sigma),
        float(model.mpp.nu_0), float(model.mpp.nu_minus),
        float(model.mpp.Ri_c), float(model.mpp.delta_Ri), float(model.mpp.Pr),
        float(model.H), float(model.tau), float(model.f),
    ) + bc_tail


def tendency_coefficients(tau, H, sig_uw, sig_vw, sig_wT, sig_u, sig_v, sig_T):
    """``(R_u, R_v, R_T) = tau/H * sigma_flux / sigma_var`` (``NDE_training.jl:149-165``)."""
    r = tau / H
    return r * sig_uw / sig_u, r * sig_vw / sig_v, r * sig_wT / sig_T


def divergence_matrix(Ru: float, Rv: float, RT: float, Nz: int, dtype=np.float32) -> np.ndarray:
    """``(3 Nz, 3 Nz)``: packed interior-face fluxes -> scaled tendencies.

    Input lane ``b Nz + j`` (``j <= Nz - 2``) holds interior face ``j + 1``
    of variable ``b``; seam lanes have zero rows. Output lane ``b Nz + k``
    is ``-R_b (F[k+1] - F[k]) / dz`` without the boundary faces.
    """
    dz = 1.0 / Nz
    R = (Ru, Rv, RT)
    Dr = np.zeros((3 * Nz, 3 * Nz), dtype)
    for b in range(3):
        o = b * Nz
        for k in range(Nz - 1):
            Dr[o + k, o + k] = -R[b] / dz
            Dr[o + k, o + k + 1] = +R[b] / dz
    return Dr


def bc_tendency_row(Ru, Rv, RT, bots, tops, Nz: int):
    """Boundary-face BC contribution to the packed tendencies.

    ``sum_b R_b Nz (bot_b e_{b Nz} - top_b e_{b Nz + Nz - 1})``. Floats give
    a numpy row; tensor BCs (with a trailing unit axis) a tensor row.
    """
    K = None
    for b, R in enumerate((Ru, Rv, RT)):
        e_bot = np.zeros(3 * Nz, np.float32)
        e_bot[b * Nz] = 1.0
        e_top = np.zeros(3 * Nz, np.float32)
        e_top[b * Nz + Nz - 1] = 1.0
        if isinstance(bots[b], torch.Tensor):  # traced BCs (the split stepper's row)
            e_bot = torch.as_tensor(e_bot, dtype=bots[b].dtype, device=bots[b].device)
            e_top = torch.as_tensor(e_top, dtype=bots[b].dtype, device=bots[b].device)
        term = (R * Nz) * (bots[b] * e_bot - tops[b] * e_top)
        K = term if K is None else K + term
    return K


def _assembly_constants(consts: tuple, Nz: int, dtype=np.float32):
    """``(Dr, Krow, w1, w2)`` for the MXU-assembled RHS.

    ``Krow`` carries the boundary-face BC fluxes and the Coriolis mean
    terms; ``w1 * roll(x, -Nz) + w2 * roll(x, +Nz)`` is the rotation (v into
    the u block, u into the v block).
    """
    (
        Hga, sig_u, sig_v, sig_T, mu_u, mu_v, sig_uw, sig_vw, sig_wT,
        nu0, nu1, Ric, dRi, Pr, H, tau, fcor,
        uw_bot, uw_top, vw_bot, vw_top, wT_bot, wT_top,
    ) = consts
    R = tendency_coefficients(tau, H, sig_uw, sig_vw, sig_wT, sig_u, sig_v, sig_T)
    bots = (uw_bot, vw_bot, wT_bot)
    tops = (uw_top, vw_top, wT_top)
    cf_u = fcor * tau / sig_u
    cf_v = fcor * tau / sig_v

    Dr = divergence_matrix(R[0], R[1], R[2], Nz, dtype)
    Krow = np.asarray(bc_tendency_row(R[0], R[1], R[2], bots, tops, Nz), dtype)[None, :].copy()
    w1 = np.zeros((1, 3 * Nz), dtype)
    w2 = np.zeros((1, 3 * Nz), dtype)
    Krow[0, 0:Nz] += cf_u * mu_v
    Krow[0, Nz : 2 * Nz] += -cf_v * mu_u
    w1[0, 0:Nz] = cf_u * sig_v
    w2[0, Nz : 2 * Nz] = -cf_v * sig_u
    return Dr, Krow, w1, w2


def fold_divergence_constants(consts: tuple, Nz: int, dtype=np.float32):
    """Lane vectors replacing the ``mpp @ Dr`` matmul:
    ``mpp @ Dr == C2a * roll(nud, 1) - C2b * nud`` with ``nud = nu * d``."""
    (
        Hga, sig_u, sig_v, sig_T, mu_u, mu_v, sig_uw, sig_vw, sig_wT,
        nu0, nu1, Ric, dRi, Pr, H, tau, fcor,
        *_bcs,
    ) = consts
    dz = 1.0 / Nz
    R = tendency_coefficients(tau, H, sig_uw, sig_vw, sig_wT, sig_u, sig_v, sig_T)
    c = (sig_u / sig_uw / H / dz, sig_v / sig_vw / H / dz, sig_T / sig_wT / H / Pr / dz)
    C2a = np.zeros(3 * Nz, dtype)
    C2b = np.zeros(3 * Nz, dtype)
    for b in range(3):
        o = b * Nz
        coef = R[b] / dz * c[b]
        C2a[o + 1 : o + Nz] = coef
        C2b[o : o + Nz - 1] = coef
    return C2a, C2b


def _rhs_coefficients(consts: tuple, Nz: int) -> dict:
    """The RHS's folded scalar coefficients, shared by the plain body and the kernel.

    Ri on raw differences ``d = x[k+1] - x[k]``:
    ``Ri = aT (dT + eps dz) / (au (du + eps dz)^2 + av (dv + eps dz)^2)``;
    ``nu = n_a + n_b tanh(t_a Ri + t_b)``; the mPP interior flux is
    ``c_b nu d`` (``c`` folds ``1/dz``); ``rd_b = R_b / dz`` is the
    divergence stencil's weight.
    """
    (
        Hga, sig_u, sig_v, sig_T, mu_u, mu_v, sig_uw, sig_vw, sig_wT,
        nu0, nu1, Ric, dRi, Pr, H, tau, fcor,
        *_bcs,
    ) = consts
    dz = 1.0 / Nz
    eps = 1e-7
    R = tendency_coefficients(tau, H, sig_uw, sig_vw, sig_wT, sig_u, sig_v, sig_T)
    return dict(
        epsdz=eps * dz,
        au=(sig_u / dz) ** 2, av=(sig_v / dz) ** 2, aT=Hga * sig_T / dz,
        n_a=nu0 + 0.5 * nu1, n_b=-0.5 * nu1, t_a=1.0 / dRi, t_b=-Ric / dRi,
        cu=sig_u / sig_uw / H / dz, cv=sig_v / sig_vw / H / dz, cT=sig_T / sig_wT / H / Pr / dz,
        rdu=R[0] / dz, rdv=R[1] / dz, rdT=R[2] / dz,
    )


def _make_mxu_rhs(consts: tuple, Nz: int, activation: str, matmul_dtype=None, fold_divergence: bool = False):
    """The MXU-assembly RHS body: the plain version of the CUDA kernels' RHS.

    Packed roll-by-1 gradients, the 3-matmul NN chain, divergence as one
    matmul with the bidiagonal ``Dr``, Coriolis as two ``Nz``-lane rolls,
    and the constant row ``Krow``. Returns ``rhs(x, A1, b1, A2, b2, A3, b3,
    Dr, Krow, w1, w2)`` on the last axis; with ``fold_divergence=True``,
    ``rhs(x, A1, b1, A2, b2, A3f, b3f, C2a, C2b, Krow, w1, w2)`` where the
    caller precomposed ``A3f = A3 @ Dr``, ``b3f = b3 @ Dr``.

    ``matmul_dtype=None`` takes each NN product in the state's dtype (the
    f64 training path needs this). ``torch.bfloat16`` rounds both inputs of
    each NN product to bf16 (to nearest even) and multiplies in f32, as
    JAX's ``preferred_element_type=float32``; ``bf16 @ bf16`` in torch would
    round the result to bf16 as well. The divergence product stays f32.
    """
    c = _rhs_coefficients(consts, Nz)
    epsdz, au, av, aT = c["epsdz"], c["au"], c["av"], c["aT"]
    n_a, n_b, t_a, t_b = c["n_a"], c["n_b"], c["t_a"], c["t_b"]
    cu, cv, cT = c["cu"], c["cv"], c["cT"]
    act = _resolve_activation(activation)

    def mm(x, A):
        if matmul_dtype is None:
            return x @ A
        return x.to(matmul_dtype).float() @ A.to(matmul_dtype).float()

    def face_terms(x):
        d = torch.roll(x, -1, dims=-1) - x  # packed raw differences; seam lanes junk
        du = d[..., 0:Nz]
        dv = d[..., Nz : 2 * Nz]
        dT = d[..., 2 * Nz : 3 * Nz]
        eu = du + epsdz
        ev = dv + epsdz
        eT = dT + epsdz
        Ri = aT * eT / (au * eu * eu + av * ev * ev)
        nu = n_a + n_b * torch.tanh(t_a * Ri + t_b)
        return nu, du, dv, dT

    def rotation(x, w1, w2):
        return w1 * torch.roll(x, -Nz, dims=-1) + w2 * torch.roll(x, Nz, dims=-1)

    def rhs(x, A1, b1, A2, b2, A3, b3, Dr, Krow, w1, w2):
        nu, du, dv, dT = face_terms(x)
        a1 = act(mm(x, A1) + b1)
        a2 = act(mm(a1, A2) + b2)
        y = mm(a2, A3) + b3  # (..., 3 Nz), seam lanes structurally zero
        mpp = torch.cat([cu * (nu * du), cv * (nu * dv), cT * (nu * dT)], dim=-1)
        flux = y - mpp
        return flux @ Dr + rotation(x, w1, w2) + Krow

    def rhs_folded(x, A1, b1, A2, b2, A3f, b3f, C2a, C2b, Krow, w1, w2):
        nu, du, dv, dT = face_terms(x)
        a1 = act(mm(x, A1) + b1)
        a2 = act(mm(a1, A2) + b2)
        ydiv = mm(a2, A3f) + b3f
        nud = torch.cat([nu * du, nu * dv, nu * dT], dim=-1)
        mppdiv = C2a * torch.roll(nud, 1, dims=-1) - C2b * nud
        return ydiv - mppdiv + rotation(x, w1, w2) + Krow

    return rhs_folded if fold_divergence else rhs


def _multistep_plain(x0, operands, consts: tuple, Nz: int, activation: str, dt: float, n_steps: int,
                     matmul_dtype=None):
    """The CUDA kernels' plain version: ``n_steps`` of RK4 over :func:`_make_mxu_rhs`."""
    rhs = _make_mxu_rhs(consts, Nz, activation, matmul_dtype)
    x = x0
    for _ in range(n_steps):
        k1 = rhs(x, *operands)
        k2 = rhs(x + 0.5 * dt * k1, *operands)
        k3 = rhs(x + 0.5 * dt * k2, *operands)
        k4 = rhs(x + dt * k3, *operands)
        x = x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


MATMUL_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class FusedRunner:
    """``run(x0) -> x_final`` with the weights packed and resident on one device.

    For a CUDA ``x0`` it launches ``csrc/fused_rk4.cu``, or
    ``csrc/fused_rk4_bf16.cu`` when ``matmul_dtype="bfloat16"``; for a CPU
    ``x0`` it runs :func:`_multistep_plain` with the same matmul dtype.
    ``x0`` must lie on the runner's device. With bf16 matmuls the three NN
    weight matrices are rounded to bf16 once, here, as the JAX runner casts
    them; biases and the assembly constants stay f32.
    """

    def __init__(self, consts: tuple, mats: tuple, Nz: int, h1: int, h2: int, activation: str,
                 dt: float, n_steps: int, n_columns: int, device: torch.device, matmul_dtype: str = "float32"):
        _resolve_activation(activation)
        self.consts, self.Nz, self.activation = consts, Nz, activation
        self.dt, self.n_steps, self.n_columns = float(dt), int(n_steps), int(n_columns)
        self.device = device
        self.matmul_dtype = MATMUL_DTYPES[matmul_dtype]
        wdt = self.matmul_dtype or torch.float32
        # (A1, b1, A2, b2, A3, b3, Dr, Krow, w1, w2), block-aligned last layer.
        self.operands = tuple(
            torch.as_tensor(a, dtype=torch.float32, device=device).to(wdt if i in (0, 2, 4) else torch.float32)
            for i, a in enumerate(mats)
        )
        self.h1, self.h2 = h1, h2
        self.kernel_weights = None
        self.kernel_frags = None
        self.kernel_params = None
        if device.type == "cuda":
            weights, frags = self.kernel_buffers()
            self.kernel_weights = torch.as_tensor(weights, device=device)
            if frags is not None:
                self.kernel_frags = torch.as_tensor(frags.view(np.int16), device=device).view(torch.bfloat16)
            self.kernel_params = self.make_kernel_params()

    def kernel_buffers(self):
        """The kernel's packed weights as numpy: ``(f32 weights, None)`` for the f32 kernel,
        ``(f32 rows, bf16 fragment bits as uint16)`` for the bf16 one."""
        A1, b1, A2, b2, A3, b3, _Dr, Krow, w1, w2 = (a.cpu().float().numpy() for a in self.operands)
        if self.matmul_dtype is None:
            return _cuda.pack_weights(A1, b1, A2, b2, A3, b3, Krow, w1, w2, self.Nz, self.h1, self.h2), None
        # The operands hold the bf16-rounded weights, so the fragments take them as they are.
        return _cuda.pack_weights_bf16(A1, b1, A2, b2, A3, b3, Krow, w1, w2, self.Nz, self.h1, self.h2)

    def make_kernel_params(self) -> "_cuda._Params":
        return _cuda.make_params(
            n_columns=self.n_columns, n_steps=self.n_steps, Nz=self.Nz, h1=self.h1, h2=self.h2,
            activation=self.activation, dt=self.dt, coefficients=_rhs_coefficients(self.consts, self.Nz),
        )

    def plain(self, x0):
        """The kernel's plain version, :func:`_multistep_plain`, on this runner's operands."""
        return _multistep_plain(x0, self.operands, self.consts, self.Nz, self.activation, self.dt, self.n_steps,
                                self.matmul_dtype)

    def __call__(self, x0):
        if not isinstance(x0, torch.Tensor):
            x0 = torch.as_tensor(np.asarray(x0), device=self.device)
        x0 = x0.to(torch.float32)
        if x0.device != self.device:
            raise ValueError(f"runner lives on {self.device}, x0 on {x0.device}")
        if tuple(x0.shape) != (self.n_columns, 3 * self.Nz):
            raise ValueError(f"runner expects x0 of shape ({self.n_columns}, {3 * self.Nz}), got {tuple(x0.shape)}")
        if x0.device.type == "cuda":
            if self.matmul_dtype is None:
                return _cuda.FUSED_RK4(x0.contiguous(), self.kernel_weights, self.kernel_params)
            return _cuda.FUSED_RK4_BF16(x0.contiguous(), self.kernel_weights, self.kernel_frags, self.kernel_params)
        if x0.device.type == "cpu":
            return self.plain(x0)
        raise ValueError(f"no fused RK4 path for device {x0.device}")


def _check_matmul_dtype(matmul_dtype: str):
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be 'float32' or 'bfloat16', got {matmul_dtype!r}")


def make_fused_runner_mxu(model, nns, bcs, dt: float, n_steps: int, n_columns: int, column_block: int = 2048,
                          matmul_dtype: str = "float32", loop_unroll: int = 1, *, device=None) -> FusedRunner:
    """Runner for the MXU-assembly variant (block-aligned last layer).

    Same restrictions as the TPU kernel: non-diurnal, ``use_mpp`` +
    ``zero_weights``, no smoothing. ``matmul_dtype="bfloat16"`` feeds the
    three NN products bf16 inputs with f32 accumulation (the divergence
    stays f32). ``column_block`` and ``loop_unroll`` do not change the
    result.
    """
    del column_block, loop_unroll
    _assert_fused_config(model)
    _check_matmul_dtype(matmul_dtype)
    Nz = model.Nz
    consts = _scalar_constants(model, bcs)
    (A1, b1, A2, b2, A3, b3), (h1, h2, _) = _pack_block_weights(nns, Nz, pad_to_block=True)
    Dr, Krow, w1, w2 = _assembly_constants(consts, Nz)
    return FusedRunner(consts, (A1, b1, A2, b2, A3, b3, Dr, Krow, w1, w2), Nz, h1, h2, nns.uw.activation,
                       dt, n_steps, n_columns, resolve_device(device), matmul_dtype)


def fused_wind_mixing_multistep_mxu(model, nns, bcs, x0, dt, n_steps, column_block: int = 2048,
                                    matmul_dtype: str = "float32", loop_unroll: int = 1, *, device=None):
    """One-shot convenience wrapper around :func:`make_fused_runner_mxu`."""
    run = make_fused_runner_mxu(model, nns, bcs, dt, n_steps, x0.shape[0], column_block, matmul_dtype,
                                loop_unroll, device=device)
    return run(x0)


def make_fast_rhs(model, nns, bcs, fold_divergence: bool = False, *, device=None):
    """The MXU-assembly RHS as plain tensor code: returns ``rhs(x, t)``.

    ``fold_divergence=True`` precomposes ``Dr`` into the last NN layer (in
    f64, before the f32 cast) and replaces the mPP divergence matmul with the
    :func:`fold_divergence_constants` roll-subtract.
    """
    _assert_fused_config(model)
    device = resolve_device(device)
    Nz = model.Nz
    consts = _scalar_constants(model, bcs)
    (A1, b1, A2, b2, A3, b3), _ = _pack_block_weights(nns, Nz, dtype=np.float64, pad_to_block=True)
    Dr, Krow, w1, w2 = _assembly_constants(consts, Nz, dtype=np.float64)
    if fold_divergence:
        C2a, C2b = fold_divergence_constants(consts, Nz, dtype=np.float64)
        raw = (A1, b1, A2, b2, A3 @ Dr, b3 @ Dr, C2a, C2b, Krow, w1, w2)
    else:
        raw = (A1, b1, A2, b2, A3, b3, Dr, Krow, w1, w2)
    # Row constants as 1-D vectors, so unbatched (3 Nz,) states stay unbatched.
    mats = tuple(
        torch.as_tensor(a[0] if a.ndim == 2 and a.shape[0] == 1 else a, dtype=torch.float32, device=device)
        for a in raw
    )
    body = _make_mxu_rhs(consts, Nz, nns.uw.activation, fold_divergence=fold_divergence)

    def rhs(x, t):
        del t
        return body(x, *mats)

    return rhs


def make_fused_runner(model, nns, bcs, dt: float, n_steps: int, n_columns: int, column_block: int = 512,
                      *, device=None) -> FusedRunner:
    """Runner for the v1 kernel's entry point, with its compact packing.

    The v1 TPU kernel writes the last layer in the compact ``3 (Nz - 1)``
    layout and assembles the divergence with explicit BC faces; the
    trajectory is the same, so the compact last layer is placed in the
    block-aligned layout and the one CUDA kernel serves both entry points.
    ``column_block`` does not change the result.
    """
    del column_block
    _assert_fused_config(model)
    Nz = model.Nz
    consts = _scalar_constants(model, bcs)
    (A1, b1, A2, b2, A3c, b3c), (h1, h2, ni) = _pack_block_weights(nns, Nz)
    A3 = np.zeros((A3c.shape[0], 3 * Nz), np.float32)
    b3 = np.zeros((1, 3 * Nz), np.float32)
    for b in range(3):
        A3[:, b * Nz : b * Nz + ni] = A3c[:, b * ni : (b + 1) * ni]
        b3[:, b * Nz : b * Nz + ni] = b3c[:, b * ni : (b + 1) * ni]
    Dr, Krow, w1, w2 = _assembly_constants(consts, Nz)
    return FusedRunner(consts, (A1, b1, A2, b2, A3, b3, Dr, Krow, w1, w2), Nz, h1, h2, nns.uw.activation,
                       dt, n_steps, n_columns, resolve_device(device))


def fused_wind_mixing_multistep(model, nns, bcs, x0, dt: float, n_steps: int, column_block: int = 512,
                                *, device=None):
    """One-shot convenience wrapper around :func:`make_fused_runner`."""
    run = make_fused_runner(model, nns, bcs, dt, n_steps, x0.shape[0], column_block, device=device)
    return run(x0)
