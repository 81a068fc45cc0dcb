"""Matplotlib plots and animations of evaluation results.

Port of the JAX package's ``eval/animations.py`` (the reference's Plots.jl /
CairoMakie figures):

- :func:`animate_profiles`                   -> ``src/DataWrangling/animate_gif.jl:1-19``,
  ``free_convection/src/animations.jl:12-118``
- :func:`animate_profiles_fluxes_comparison` -> ``wind_mixing/src/animation.jl:345+``
- :func:`plot_loss`                          -> ``wind_mixing/src/loss.jl:48-105``
- :func:`plot_loss_matrix`                   -> ``free_convection/src/testing.jl:186-231``
- :func:`plot_epoch_loss`                    -> ``free_convection/src/testing.jl:34-62``

Figures render headless (Agg). Animations dispatch on the output
extension: ``.gif`` through pillow, ``.mp4`` through an OpenCV
``VideoWriter``. Everything takes finished arrays (numpy, or tensors on
any device), so no solver imports this module; the commands import it
after their solves, and where matplotlib is missing (the card's machine)
they write their arrays without figures (``eval/report.py::animations_or_none``).
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.animation as manimation  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402


def _np(x) -> np.ndarray:
    """A numpy copy of an array or a tensor on any device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class _CV2Writer(manimation.AbstractMovieWriter):
    """Minimal mp4 writer over ``cv2.VideoWriter`` (no ffmpeg needed).

    Implements the ``setup`` / ``grab_frame`` / ``finish`` contract that
    ``Animation.save`` drives through its ``saving()`` context manager.
    """

    def __init__(self, fps: int = 15):
        super().__init__(fps=fps)
        self._writer = None

    def setup(self, fig, outfile, dpi=None):
        super().setup(fig, outfile, dpi=dpi)
        self._frame_size = None

    def grab_frame(self, **savefig_kwargs):
        import cv2

        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())[..., :3]
        if self._writer is None:
            h, w = buf.shape[:2]
            self._frame_size = (w, h)
            self._writer = cv2.VideoWriter(str(self.outfile), cv2.VideoWriter_fourcc(*"mp4v"), self.fps, (w, h))
            if not self._writer.isOpened():
                raise RuntimeError(f"cv2.VideoWriter failed to open {self.outfile!r}")
        if (buf.shape[1], buf.shape[0]) != self._frame_size:
            # cv2.VideoWriter.write drops a frame of another size without an error.
            raise RuntimeError(f"frame size changed mid-animation: {(buf.shape[1], buf.shape[0])} "
                               f"vs initial {self._frame_size}")
        self._writer.write(cv2.cvtColor(buf, cv2.COLOR_RGB2BGR))

    def finish(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None


def save_animation(anim, path: str, fps: int):
    """Write ``anim`` to ``path`` by its extension (``.mp4``: OpenCV; anything else: a pillow GIF)."""
    if str(path).lower().endswith(".mp4"):
        anim.save(path, writer=_CV2Writer(fps=fps))
    else:
        anim.save(path, writer=manimation.PillowWriter(fps=fps))


def animate_profiles(profiles: dict, z, t, path: str, xlabel: str = "", fps: int = 15, stride: int = 1):
    """Animate named profiles against depth over time.

    ``profiles``: ``{label: (Nt, Nz_like)}``; entries may sit on centers or
    faces; ``z`` is a dict keyed the same way or one array shared by all.
    """
    t = _np(t)
    profiles = {label: _np(p) for label, p in profiles.items()}
    frames = range(0, t.shape[0], stride)
    fig, ax = plt.subplots(figsize=(5, 6))

    lines = {}
    for label, prof in profiles.items():
        zi = _np(z[label] if isinstance(z, dict) else z)
        (lines[label],) = ax.plot(prof[0], zi, label=label)
    # Limits from the finite values: a diverged run is when the animation is wanted.
    finite = [p[np.isfinite(p)] for p in profiles.values()]
    finite = [f for f in finite if f.size]
    if finite:
        lo = min(float(f.min()) for f in finite)
        hi = max(float(f.max()) for f in finite)
        pad = 0.05 * (hi - lo + 1e-12)
        ax.set_xlim(lo - pad, hi + pad)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("z [m]")
    ax.legend(loc="lower right", fontsize=8)
    title = ax.set_title("")

    def update(i):
        for label, prof in profiles.items():
            lines[label].set_xdata(prof[i])
        title.set_text(f"t = {t[i] / 86400:.2f} days")
        return list(lines.values())

    anim = manimation.FuncAnimation(fig, update, frames=frames, blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path


def animate_profiles_fluxes_comparison(ev, path: str, fps: int = 15, stride: int = 1,
                                       models=("truth", "nde", "mpp", "kpp")):
    """7-panel animation (u, v, T | u'w', v'w', w'T' | Ri) of a ``ProfileEvaluation`` or its dict.

    Parity: ``animate_profiles_fluxes_comparison`` (``animation.jl:345+``).
    """
    data = ev.to_dict() if hasattr(ev, "to_dict") else dict(ev)
    data = {k: _np(v) for k, v in data.items()}
    t = data["t"]
    zc, zf = data["zc"], data["zf"]
    frames = range(0, t.shape[0], stride)

    panels = [
        ("u", "u [m/s]", zc), ("v", "v [m/s]", zc), ("T", "T [C]", zc),
        ("uw", "u'w' [m2/s2]", zf), ("vw", "v'w' [m2/s2]", zf), ("wT", "w'T' [m/s C]", zf),
        ("Ri", "Ri", zf),
    ]
    fig, axes = plt.subplots(2, 4, figsize=(16, 8), sharey=True)
    axes = axes.ravel()
    lines = {}
    for ax, (var, label, zaxis) in zip(axes, panels):
        for m in models:
            key = f"{m}_{var}"
            if key in data:
                (lines[key],) = ax.plot(data[key][0], zaxis, label=m)
        vals = [data[f"{m}_{var}"] for m in models if f"{m}_{var}" in data]
        vals = [v[np.isfinite(v)] for v in vals]
        vals = [v for v in vals if v.size]
        if vals:
            lo = min(float(v.min()) for v in vals)
            hi = max(float(v.max()) for v in vals)
            if var == "Ri":
                lo, hi = -1.0, 2.0
            pad = 0.05 * (hi - lo + 1e-12)
            ax.set_xlim(lo - pad, hi + pad)
        ax.set_xlabel(label)
    axes[0].set_ylabel("z [m]")
    axes[4].set_ylabel("z [m]")
    axes[-1].axis("off")
    axes[0].legend(loc="lower right", fontsize=8)
    title = fig.suptitle("")

    def update(i):
        for key, line in lines.items():
            line.set_xdata(data[key][i])
        title.set_text(f"t = {t[i] / 86400:.2f} days")
        return list(lines.values())

    anim = manimation.FuncAnimation(fig, update, frames=frames, blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path


def plot_loss(losses: dict, t, path: str, ylabel: str = "MSE", logy: bool = True):
    """Per-timestep loss curves for named solutions (``loss.jl:48-105``)."""
    fig, ax = plt.subplots(figsize=(7, 4.5))
    t_days = _np(t) / 86400.0
    for name, curve in losses.items():
        ax.plot(t_days, _np(curve), label=name)
    if logy:
        ax.set_yscale("log")
    ax.set_xlabel("t [days]")
    ax.set_ylabel(ylabel)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_gp_uncertainty(pred, truth, variance, path: str, flux: str = "wT", frame: int = -1):
    """GP flux prediction with a +/-2 sigma posterior band against the truth.

    Parity: the reference plots ``uncertainty`` beside ``model_output``
    (``gaussian_process.jl:130-139``). ``pred`` / ``truth``: ``(N, F)``
    scaled flux profiles; ``variance``: ``(N,)`` posterior variance per
    query point (one per input state, so the band is the same at every level).
    """
    pred = _np(pred)
    truth = _np(truth)
    sd = np.sqrt(np.maximum(_np(variance), 0.0))
    levels = np.arange(pred.shape[-1])
    fig, ax = plt.subplots(figsize=(5, 6))
    p, t = pred[frame], truth[frame]
    ax.fill_betweenx(levels, p - 2 * sd[frame], p + 2 * sd[frame], alpha=0.25, label="+/-2 sigma")
    ax.plot(p, levels, label="GP mean")
    ax.plot(t, levels, "k--", label="truth")
    ax.set_xlabel(f"{flux} (scaled)")
    ax.set_ylabel("face index")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_nde_ensemble_uncertainty(uq: dict, truth_T, path: str, frame: int = -1):
    """Deep-ensemble T profile with a +/-2 sigma predictive band against the truth.

    The NN-closure analogue of :func:`plot_gp_uncertainty`. ``uq``: the dict
    of ``eval/ensemble_uq.py::nde_ensemble_uq``; ``truth_T``: dimensional
    ``(Nt, Nz)`` truth profiles on the same window.
    """
    mean = _np(uq["ensemble_T_mean"])[frame]
    sd = _np(uq["ensemble_T_std"])[frame]
    truth = _np(truth_T)[frame].reshape(-1)
    zc = _np(uq["zc"])
    fig, ax = plt.subplots(figsize=(5, 6))
    ax.fill_betweenx(zc, mean - 2 * sd, mean + 2 * sd, alpha=0.25, label="+/-2 sigma")
    ax.plot(mean, zc, label=f"ensemble mean (K={int(uq['n_members'])})")
    ax.plot(truth, zc, "k--", label="truth")
    ax.set_xlabel("T (degC)")
    ax.set_ylabel("z (m)")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_epoch_loss(epoch_losses, path: str, label: str = "training loss"):
    """Loss against training epoch (``testing.jl:34-62``)."""
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(_np(epoch_losses), label=label)
    ax.set_yscale("log")
    ax.set_xlabel("epoch")
    ax.set_ylabel("MSE")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_loss_matrix(matrix: dict, sim_names, path: str):
    """Heatmap of simulations x solution types (``testing.jl:186-231``); ``matrix``: ``{solution: (S,) losses}``."""
    names = list(matrix.keys())
    arr = np.stack([_np(matrix[n]).reshape(-1) for n in names], axis=1)  # (S, M)
    fig, ax = plt.subplots(figsize=(2 + 1.2 * len(names), 1 + 0.6 * arr.shape[0]))
    im = ax.imshow(np.log10(arr + 1e-30), aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(names)), names, rotation=30, ha="right")
    ax.set_yticks(range(arr.shape[0]), [str(s) for s in sim_names])
    for i in range(arr.shape[0]):
        for j in range(len(names)):
            ax.text(j, i, f"{arr[i, j]:.2e}", ha="center", va="center", fontsize=7, color="w")
    fig.colorbar(im, ax=ax, label="log10 MSE")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def animate_training_data(var_les, z_les, var_coarse, z_coarse, t, path: str, xlabel: str = "T [C]", fps: int = 15,
                          stride: int = 1):
    """Animate the high-resolution LES against its coarse-grained training profile.

    Parity: ``animate_training_data`` (``free_convection/src/animations.jl:12-60``).
    """
    return animate_profiles({"LES": _np(var_les), "coarse": _np(var_coarse)},
                            {"LES": _np(z_les), "coarse": _np(z_coarse)}, t, path, xlabel=xlabel, fps=fps,
                            stride=stride)


def animate_nde_loss(per_timestep_losses, t, path: str, fps: int = 10, ylabel: str = "MSE"):
    """Animate the per-timestep loss curve as training progresses.

    ``per_timestep_losses``: ``(E, Nt)``, one loss-against-time curve per
    saved epoch (``eval/loss_matrix.py::loss_per_timestep_matrix``). Parity:
    ``animate_nde_loss`` (``free_convection/src/testing.jl:64-101``).
    """
    curves = _np(per_timestep_losses)
    t_days = _np(t) / 86400.0
    fig, ax = plt.subplots(figsize=(7, 4.5))
    (line,) = ax.plot(t_days, curves[0])
    ax.set_yscale("log")
    lo, hi = max(curves.min(), 1e-30), curves.max()
    ax.set_ylim(lo * 0.5, hi * 2)
    ax.set_xlabel("t [days]")
    ax.set_ylabel(ylabel)
    title = ax.set_title("")

    def update(e):
        line.set_ydata(curves[e])
        title.set_text(f"epoch {e}")
        return [line]

    anim = manimation.FuncAnimation(fig, update, frames=range(curves.shape[0]), blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path


def animate_polynomial_decomposition(f_values, x, path: str, kind: str = "legendre", n_max: int = 12, fps: int = 2,
                                     domain=None):
    """Animate the running orthogonal-basis reconstruction of a profile.

    Frame ``n`` shows the function against its reconstruction from the
    first ``n`` coefficients (``utils/polynomial.py``). Parity: the animated
    demos of ``src/polynomial_decomposition.jl:6-65``.
    """
    from climateparameterizations_jl_tpu_torch.utils.polynomial import polynomial_decomposition, reconstruct

    x = _np(x)
    f_values = _np(f_values)
    coeffs = polynomial_decomposition(f_values, x, kind=kind, n=n_max, domain=domain)

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(x, f_values, "k-", lw=2, label="f")
    (line,) = ax.plot(x, np.zeros_like(f_values), "r--", label="reconstruction")
    ax.legend(fontsize=8)
    title = ax.set_title("")

    def update(k):
        line.set_ydata(_np(reconstruct(coeffs[: k + 1], x, kind=kind, domain=domain)))
        title.set_text(f"{kind}: first {k + 1} terms")
        return [line]

    anim = manimation.FuncAnimation(fig, update, frames=range(n_max), blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path


def animate_les_slices(T_frames, w_frames, H: float, path: str, fps: int = 8):
    """Animate vertical (x-z) slices of the 3-D LES: temperature and w at mid-basin y.

    ``T_frames``: ``(Nt, Ny, Nx, Nz)`` center temperatures; ``w_frames``:
    ``(Nt, Ny, Nx, Nz+1)`` face vertical velocity. Parity: the reference's
    3-D LES rendering (``wind_mixing/src/animation.jl:1300+``), as planar slices.
    """
    T = _np(T_frames)
    w = _np(w_frames)
    j = T.shape[1] // 2
    Ts = np.swapaxes(T[:, j], 1, 2)  # (Nt, Nz, Nx)
    ws = np.swapaxes(0.5 * (w[:, j, :, :-1] + w[:, j, :, 1:]), 1, 2)
    extent = (0, Ts.shape[2], -H, 0.0)

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    ims = [
        axes[0].imshow(Ts[0], origin="lower", cmap="RdYlBu_r", aspect="auto", vmin=Ts.min(), vmax=Ts.max(),
                       extent=extent),
        axes[1].imshow(ws[0], origin="lower", cmap="RdBu_r", aspect="auto", vmin=-np.abs(ws).max() - 1e-12,
                       vmax=np.abs(ws).max() + 1e-12, extent=extent),
    ]
    for ax, im, label in zip(axes, ims, ("T [C]", "w [m/s]")):
        ax.set_title(label)
        ax.set_ylabel("z [m]")
        fig.colorbar(im, ax=ax, shrink=0.85)

    def update(k):
        ims[0].set_data(Ts[k])
        ims[1].set_data(ws[k])
        return ims

    anim = manimation.FuncAnimation(fig, update, frames=range(T.shape[0]), blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path


def animate_double_gyre(traj, model, path: str, fps: int = 8):
    """Animate the basin: SST, free surface and barotropic streamfunction.

    ``traj``: a trajectory ``DoubleGyreState`` (time-leading fields) of
    ``model``. psi comes from ``embed/double_gyre.py::barotropic_streamfunction``
    in one call over the time axis. Parity: the reference's double-gyre
    plot scripts (``free_convection/plot_double_gyre*.jl``), as planar fields.
    """
    from climateparameterizations_jl_tpu_torch.embed.double_gyre import barotropic_streamfunction

    T = _np(traj.T)  # (Nt, Ny, Nx, Nz)
    eta = _np(traj.eta)
    psi = _np(barotropic_streamfunction(model, traj.u)) / 1e6

    fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
    sst = T[..., -1]
    ims = [
        axes[0].imshow(sst[0], origin="lower", cmap="RdYlBu_r", vmin=sst.min(), vmax=sst.max()),
        axes[1].imshow(eta[0], origin="lower", cmap="BrBG", vmin=eta.min(), vmax=eta.max()),
        axes[2].imshow(psi[0], origin="lower", cmap="RdBu_r", vmin=-np.abs(psi).max(), vmax=np.abs(psi).max()),
    ]
    for ax, im, label in zip(axes, ims, ("SST [C]", "eta [m]", "psi [Sv]")):
        ax.set_title(label)
        fig.colorbar(im, ax=ax, shrink=0.85)

    def update(k):
        ims[0].set_data(sst[k])
        ims[1].set_data(eta[k])
        ims[2].set_data(psi[k])
        return ims

    anim = manimation.FuncAnimation(fig, update, frames=range(T.shape[0]), blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path


def plot_training_regions(train_names, test_names, path: str):
    """Scatter of the (momentum flux, buoyancy flux) coverage of the training and test sims.

    Parity: ``wind_mixing/plot_training_regions.jl`` /
    ``plot_training_regions_diurnal.jl``. Diurnal sims are marked (their Qb
    is the cycle's amplitude). Names that do not parse as catalog entries
    are left out; with none left, nothing is drawn and ``None`` returned.
    """
    from climateparameterizations_jl_tpu_torch.data.registry import simulation_parameters

    def parse(names):
        out = []
        for n in names:
            try:
                out.append(simulation_parameters(n))
            except KeyError:
                pass  # --data-dir names outside the catalog carry no parseable forcing
        return out

    parsed = {label: parse(names) for label, names in (("train", train_names), ("test", test_names))}
    if not any(parsed.values()):
        return None

    fig, ax = plt.subplots(figsize=(7, 5))
    for (label, pts), color in zip(parsed.items(), ("tab:blue", "tab:red")):
        steady = [(p.Qu, p.Qb) for p in pts if not p.diurnal]
        diurnal = [(p.Qu, p.Qb) for p in pts if p.diurnal]
        if steady:
            ax.scatter(*zip(*steady), c=color, marker="o", s=60, label=label)
        if diurnal:
            ax.scatter(*zip(*diurnal), c=color, marker="^", s=60, label=f"{label} (diurnal)")
    ax.set_xlabel("momentum flux magnitude |Qu| [m$^2$/s$^2$]")
    ax.set_ylabel("buoyancy flux Qb [m$^2$/s$^3$] (negative = heating)")
    ax.axhline(0.0, color="0.7", lw=0.8)
    ax.legend(fontsize=8)
    ax.set_title("training / test forcing coverage")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_final_profiles(evaluations: dict, path: str, members=("truth", "nde", "mpp", "kpp"), var: str = "T"):
    """Final-time profiles of every member, one panel per simulation.

    Parity: the ``plot_T_final_results*.jl`` figures. ``evaluations``:
    ``{sim_name: ProfileEvaluation-or-dict}``.
    """
    n = len(evaluations)
    ncols = min(n, 4)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 4.5 * nrows), sharey=True, squeeze=False)
    for ax, (name, ev) in zip(axes.ravel(), evaluations.items()):
        data = ev.to_dict() if hasattr(ev, "to_dict") else dict(ev)
        zaxis = _np(data["zc"] if var in ("u", "v", "T") else data["zf"])
        for m in members:
            key = f"{m}_{var}"
            if key in data:
                ax.plot(_np(data[key])[-1], zaxis, label=m)
        ax.set_title(name, fontsize=9)
        ax.set_xlabel(var)
    for ax in axes.ravel()[n:]:
        ax.axis("off")
    axes[0, 0].set_ylabel("z [m]")
    axes[0, 0].legend(fontsize=8)
    t_end = _np(next(iter(evaluations.values()))["t"])[-1]
    fig.suptitle(f"final {var} profiles ({t_end / 86400:.1f} days)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def _isotherm_depth(T3, iso: float, zc, dz: float):
    """z of the DEEPEST upward crossing of ``T = iso`` per column.

    Linearly interpolated between adjacent cell centers, so a warm intrusion
    above the interface does not move it. ``T3``: ``(..., Nz)``, z bottom to
    top. Columns warmer than ``iso`` throughout clamp to the bottom, colder
    throughout to the top.
    """
    d = _np(T3) - iso
    zc = _np(zc)
    crossing = (d[..., :-1] <= 0.0) & (d[..., 1:] > 0.0)
    has_cross = crossing.any(axis=-1)
    k = crossing.argmax(axis=-1)  # first True = deepest crossing (0 if none)
    d0 = np.take_along_axis(d, k[..., None], axis=-1)[..., 0]
    d1 = np.take_along_axis(d, (k + 1)[..., None], axis=-1)[..., 0]
    denom = np.where(has_cross, d0 - d1, 1.0)
    frac = np.where(has_cross, d0 / denom, 0.0)  # in [0, 1): d0 <= 0 < d1
    z_cross = zc[k] + frac * dz
    return np.where(has_cross, z_cross, np.where(d[..., 0] > 0.0, zc[0], zc[-1]))


def animate_les_3d(T_frames, H: float, path: str, iso: float | None = None, fps: int = 6, stride: int = 1):
    """3-D animation of the LES: the depth surface of a temperature isotherm.

    Parity: ``animate_LES_3D`` (``wind_mixing/src/animation.jl:1300+``),
    whose Makie volume becomes the isotherm-depth surface ``z_iso(x, y)``
    (:func:`_isotherm_depth`) on matplotlib's 3-D axes. ``T_frames``:
    ``(Nt, Ny, Nx, Nz)`` center temperatures, z bottom to top; ``iso``
    defaults to the midpoint of the first frame's range.
    """
    from mpl_toolkits.mplot3d import Axes3D  # noqa: F401 (registers the 3-D projection)

    T = _np(T_frames)
    Nt, Ny, Nx, Nz = T.shape
    zc = (np.arange(Nz) + 0.5) * (H / Nz) - H
    if iso is None:
        iso = 0.5 * (float(T[0].min()) + float(T[0].max()))
    dz = H / Nz

    X, Y = np.meshgrid(np.arange(Nx), np.arange(Ny))
    frames = range(0, Nt, stride)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")

    def draw(i):
        ax.clear()
        Z = _isotherm_depth(T[i], iso, zc, dz)
        ax.plot_surface(X, Y, Z, cmap="viridis", vmin=float(zc[0]), vmax=0.0, linewidth=0)
        ax.set_zlim(float(zc[0]), 0.0)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.set_zlabel("z [m]")
        ax.set_title(f"T = {iso:.2f} C isotherm depth, frame {i}")
        return []

    anim = manimation.FuncAnimation(fig, draw, frames=frames, blit=False)
    save_animation(anim, path, fps)
    plt.close(fig)
    return path
