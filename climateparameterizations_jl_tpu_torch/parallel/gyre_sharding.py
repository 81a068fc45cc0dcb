"""Spatial decomposition of the 3-D double gyre over a 1-D mesh along y.

Port of ``climateparameterizations_jl_tpu/parallel/gyre_sharding.py``.
There GSPMD partitions the unmodified basin step from ``P("y")``
annotations. Here each rank holds ``Ny / N`` rows of ``u``, ``T`` and
``eta`` and the ``Ny / N + 1`` v-faces around them (one face shared with
each neighbour, computed alike on both), and runs the one step body of
``embed/double_gyre.py::double_gyre_step`` with y-axis hooks
(:class:`SlabY`) written out:

- **walls and halos**: the edge and zero padding of the basin's walls
  applies at the global walls only; between ranks each y-stencil reads its
  neighbours' rows: three for the WENO5 reconstructions, one for the
  Laplacians, the pressure and surface gradients and the corner averages;
- **the free-surface solve** ``Cy @ rhs @ Cx.T`` contracts over y: each
  rank multiplies its own column block of ``Cy``, one ``all_reduce`` of the
  2-D ``(Ny, Nx)`` partial gives ``rhat`` on every rank, and each applies
  its own rows of ``Cy.T`` (TF32 off);
- **vertical mixing** stays local: Thomas launches on the rank's own
  columns.

No rank holds a whole 3-D field: ``u``, ``v``, ``T`` and ``eta`` scale as
``1 / N`` per rank (the JAX package stores ``v`` replicated).
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.embed.double_gyre import (
    DoubleGyreModel,
    DoubleGyreState,
    WalledY,
    _dct_matrix,
    _full_precision_matmuls,
    _neumann_laplacian_eigenvalues,
    double_gyre_step,
)
from climateparameterizations_jl_tpu_torch.parallel import world
from climateparameterizations_jl_tpu_torch.parallel.sharding import make_mesh

HALO = 3  # the WENO5 stencil's reach


def make_gyre_mesh(n_devices: int | None = None, device=None):
    """1-D mesh over the meridional axis (``make_mesh(..., axis_name="y")``)."""
    return make_mesh(n_devices, axis_name="y", device=device)


def state_shardings(mesh, Ny: int) -> DoubleGyreState:
    """The global rows each field of this rank holds: ``Ny / N`` cells, and the ``Ny / N + 1`` v-faces around them."""
    axis = world.axis_of(mesh)
    if Ny % axis.size:
        raise ValueError(f"Ny={Ny} not divisible by mesh size {axis.size}")
    n = Ny // axis.size
    cells = slice(axis.rank * n, (axis.rank + 1) * n)
    return DoubleGyreState(u=cells, v=slice(cells.start, cells.stop + 1), T=cells, eta=cells)


def shard_gyre_state(state: DoubleGyreState, mesh) -> DoubleGyreState:
    """This rank's block of an (unsharded) state, on the mesh's device."""
    s = state_shardings(mesh, state.T.shape[0])
    dev = world.device_of(mesh)
    return DoubleGyreState(*(getattr(state, f)[getattr(s, f)].to(dev).clone() for f in ("u", "v", "T", "eta")))


class SlabY(WalledY):
    """The y-axis hooks of ``double_gyre_step`` (:class:`WalledY`) on this rank's block of a y-decomposed mesh."""

    def __init__(self, model: DoubleGyreModel, mesh):
        self.axis = axis = world.axis_of(mesh)
        rows = state_shardings(mesh, model.Ny).T
        n = rows.stop - rows.start
        if n < HALO:
            raise ValueError(f"Ny={model.Ny} over {axis.size} ranks leaves {n} rows per rank; the WENO5 halo needs "
                             f"{HALO}")
        super().__init__(model.Ny, n, rows.start, axis.rank == 0, axis.rank == axis.size - 1)
        self.below = None if self.south_wall else axis.rank - 1
        self.above = None if self.north_wall else axis.rank + 1

    def neighbours(self, x, k: int, faces: bool):
        # Face blocks share their end faces, so the rows sent south skip the shared first one.
        shared = 1 if faces else 0
        south = world.exchange(x.narrow(0, self.n - k, k), self.above, self.below, self.axis)
        north = world.exchange(x.narrow(0, shared, k), self.below, self.above, self.axis)
        return south, north

    def free_surface(self, model: DoubleGyreModel, rhs, dt):
        """``(1 - g H dt^2 lap) d_eta = rhs`` on this rank's rows: its column block of ``Cy``, one all_reduce."""
        dtype_name = str(rhs.dtype).replace("torch.", "")
        Cy = _dct_matrix(model.Ny, dtype_name, rhs.device).narrow(1, self.offset, self.n)  # (Ny, n)
        Cx = _dct_matrix(model.Nx, dtype_name, rhs.device)
        lam = _neumann_laplacian_eigenvalues(model, rhs.dtype)
        with _full_precision_matmuls():
            rhat = world.all_reduce(Cy @ rhs @ Cx.T, self.axis)
            denom = 1.0 - model.g * model.H * dt * dt * lam
            return Cy.T @ (rhat / denom) @ Cx


def make_sharded_gyre_stepper(model: DoubleGyreModel, mesh, dt, nn=None, T_scaling=None, wT_scaling=None,
                              n_substeps: int = 1, tridiag_backend: str = "auto", T_remap=None,
                              nn_stability_gate=None):
    """``step(state) -> state``: ``n_substeps`` basin steps on this rank's block of rows.

    The NN-closure knobs (``T_remap``, ``nn_stability_gate``) are
    ``double_gyre_step``'s: the sharded path runs the closure the
    single-device runner does. Input and output are this rank's blocks
    (:func:`shard_gyre_state`); ``model.Ny`` must divide by the mesh size
    (``ValueError``), leaving at least three rows per rank. Runs without
    autograd.
    """
    y = SlabY(model, mesh)

    def advance(state: DoubleGyreState) -> DoubleGyreState:
        with torch.no_grad():
            for _ in range(n_substeps):
                state = double_gyre_step(model, state, dt, nn, T_scaling, wT_scaling, tridiag_backend, T_remap,
                                         nn_stability_gate, y=y)
        return state

    return advance


def run_double_gyre_sharded(model: DoubleGyreModel, state0: DoubleGyreState, dt, n_save: int, save_every: int,
                            mesh=None, nn=None, T_scaling=None, wT_scaling=None,
                            max_steps_per_dispatch: int | None = None, tridiag_backend: str = "auto", T_remap=None,
                            nn_stability_gate=None) -> DoubleGyreState:
    """Sharded counterpart of ``embed/double_gyre.py::run_double_gyre``: this rank's blocks of the trajectories.

    ``state0`` is the whole (unsharded) initial state; the result stacks
    ``n_save + 1`` frames of this rank's rows. ``max_steps_per_dispatch``
    (the JAX package's dispatch cap) is kept only so that a call matches the
    JAX signature; it has no effect, since the steps run eagerly.
    """
    del max_steps_per_dispatch
    mesh = mesh if mesh is not None else make_gyre_mesh(device=state0.T.device)
    state = shard_gyre_state(state0, mesh)
    step = make_sharded_gyre_stepper(model, mesh, dt, nn, T_scaling, wT_scaling, save_every, tridiag_backend,
                                     T_remap, nn_stability_gate)
    frames = [state]
    for _ in range(n_save):
        state = step(state)
        frames.append(state)
    stack = lambda f: torch.stack([getattr(fr, f) for fr in frames], dim=0)  # noqa: E731
    return DoubleGyreState(u=stack("u"), v=stack("v"), T=stack("T"), eta=stack("eta"))
