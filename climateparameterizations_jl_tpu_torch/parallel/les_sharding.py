"""Spatial decomposition of the 3-D LES over a 1-D mesh along y.

Port of ``climateparameterizations_jl_tpu/parallel/les_sharding.py``. There
GSPMD partitions the unmodified ``les_step`` from ``P("y")`` annotations and
derives the halos and the FFT transposes. Here each rank holds ``Ny / N``
rows of ``u, v, w, T`` and runs the same ``data/les.py::les_step`` body
with y-axis hooks (:class:`RingY`) written out:

- **halos**: each one-row shift ``ym`` / ``yp`` receives one row from the
  neighbouring rank around a periodic ring, and the WENO5 reconstructions
  along y (``pad3``) three rows from each side. A rank that is its own
  neighbour (a mesh of one) copies its own rows;
- **the pressure solve**: ``rfft`` over x locally, one ``all_to_all`` to
  slabs of kx modes (``Nx // 2 + 1`` padded to a multiple of N), ``fft``
  over y, the z-tridiagonal solve of the slab's modes with its slice of
  ``LESConfig.poisson_diagonals`` (one Thomas launch per rank per solve on
  the card), and the same steps back. The pinned (0, 0) mode lives on
  rank 0.

No rank ever holds a whole 3-D field.
"""

from __future__ import annotations

import torch

from climateparameterizations_jl_tpu_torch.data.les import LESConfig, LESState, _resolve_backend, les_step
from climateparameterizations_jl_tpu_torch.ops.tridiagonal import tridiagonal_solve
from climateparameterizations_jl_tpu_torch.parallel import world
from climateparameterizations_jl_tpu_torch.parallel.sharding import make_mesh

HALO = 3  # the WENO5 stencil's reach


def make_les_mesh(n_devices: int | None = None, device=None):
    """1-D mesh over the meridional (y) axis (``make_mesh(..., axis_name="y")``)."""
    return make_mesh(n_devices, axis_name="y", device=device)


def _rows(Ny: int, mesh) -> slice:
    axis = world.axis_of(mesh)
    if Ny % axis.size:
        raise ValueError(f"Ny={Ny} not divisible by mesh size {axis.size}")
    n = Ny // axis.size
    return slice(axis.rank * n, (axis.rank + 1) * n)


def state_shardings(mesh, Ny: int) -> LESState:
    """The global rows each field of this rank holds: the same ``Ny / N`` block of y for every field."""
    rows = _rows(Ny, mesh)
    return LESState(u=rows, v=rows, w=rows, T=rows)


def shard_les_state(state: LESState, mesh) -> LESState:
    """This rank's block of rows of an (unsharded) state, on the mesh's device."""
    s = state_shardings(mesh, state.T.shape[0])
    dev = world.device_of(mesh)
    return LESState(*(getattr(state, f)[getattr(s, f)].to(dev).clone() for f in ("u", "v", "w", "T")))


class RingY:
    """The y-axis hooks of ``les_step`` (``data/les.py::PeriodicY``) over a y-decomposed mesh."""

    def __init__(self, config: LESConfig, mesh):
        self.axis = axis = world.axis_of(mesh)
        N, r = axis.size, axis.rank
        rows = _rows(config.Ny, mesh)
        self.n = rows.stop - rows.start
        if self.n < HALO:
            raise ValueError(f"Ny={config.Ny} over {N} ranks leaves {self.n} rows per rank; the WENO5 halo needs "
                             f"{HALO}")
        self.south, self.north = (r - 1) % N, (r + 1) % N
        self.Nx, self.Ny, self.Nz = config.Nx, config.Ny, config.Nz
        self.Nxr = config.Nx // 2 + 1
        self.m = -(-self.Nxr // N)  # kx modes per rank
        k0 = r * self.m

        def slab(a):  # this rank's kx modes of (2, Ny, Nxr, Nz), the padding a copy of the last mode
            pad = a[:, :, -1:].expand(-1, -1, N * self.m - self.Nxr, -1)
            return torch.cat([a, pad], dim=2)[:, :, k0: k0 + self.m].contiguous()

        self.dl, self.d, self.du = (slab(a) for a in config.poisson_diagonals)
        self.pinned = r == 0  # rank 0 holds kx = 0, hence the (0, 0) mode

    def ym(self, a):
        """``a`` shifted one row north (row j holds row j - 1): the south neighbour's last row in front."""
        return torch.cat([world.exchange(a[-1:], self.north, self.south, self.axis), a[:-1]], dim=0)

    def yp(self, a):
        """``a`` shifted one row south (row j holds row j + 1): the north neighbour's first row behind."""
        return torch.cat([a[1:], world.exchange(a[:1], self.south, self.north, self.axis)], dim=0)

    def pad3(self, q):
        """``q`` with three halo rows on both ends, for the WENO5 stencil."""
        below = world.exchange(q[-HALO:], self.north, self.south, self.axis)
        above = world.exchange(q[:HALO], self.south, self.north, self.axis)
        return torch.cat([below, q, above], dim=0)

    def _transpose(self, blocks):
        """All-to-all of complex ``(N, ...)`` blocks (sent as real pairs)."""
        out = world.all_to_all(torch.view_as_real(blocks.contiguous()), self.axis)
        return torch.view_as_complex(out)

    def poisson(self, config: LESConfig, rhs, tridiag_backend: str):
        """Invert the MAC Laplacian on this rank's rows ``(n, Nx, Nz)``: a distributed 2-D FFT around one Thomas
        solve."""
        N, n, m, Nz = self.axis.size, self.n, self.m, self.Nz
        rx = torch.fft.rfft(rhs, dim=1)  # (n, Nxr, Nz)
        rx = torch.cat([rx, rx.new_zeros((n, N * m - self.Nxr, Nz))], dim=1)
        # Rows -> kx slabs: block j (this rank's rows, rank j's modes) goes to rank j.
        slab = self._transpose(rx.reshape(n, N, m, Nz).transpose(0, 1)).reshape(self.Ny, m, Nz)
        ky = torch.fft.fft(slab, dim=0)
        b = torch.stack([ky.real, ky.imag])  # (2, Ny, m, Nz)
        if self.pinned:
            b[:, 0, 0, 0] = 0.0
        x = tridiagonal_solve(self.dl, self.d, self.du, b, backend=_resolve_backend(tridiag_backend, rhs.device))
        xs = torch.fft.ifft(torch.complex(x[0], x[1]), dim=0)  # (Ny, m, Nz)
        # kx slabs -> rows: block i (rank i's rows of this rank's modes) goes back to rank i.
        back = self._transpose(xs.reshape(N, n, m, Nz)).transpose(0, 1).reshape(n, N * m, Nz)
        return torch.fft.irfft(back[:, : self.Nxr], n=self.Nx, dim=1).to(rhs.dtype)


def make_sharded_les_stepper(config: LESConfig, mesh, dt: float, method: str = "rk3", n_substeps: int = 1):
    """``step(state, t) -> state``: ``n_substeps`` LES steps from time ``t`` on this rank's rows.

    ``config.Ny`` must divide by the mesh size (``ValueError``), leaving at
    least three rows per rank. Input and output are this rank's blocks
    (:func:`shard_les_state`); on the card each rank's Poisson solves run on
    the Thomas kernel. Runs without autograd.
    """
    y = RingY(config, mesh)

    def advance(state: LESState, t) -> LESState:
        t = torch.as_tensor(t, dtype=state.T.dtype, device=state.T.device)
        with torch.no_grad():
            for _ in range(n_substeps):
                state = les_step(config, state, dt, method, t, y=y)
                t = t + dt
        return state

    return advance
