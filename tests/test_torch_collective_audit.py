"""The port's collective audit: each sharded path really decomposes its work (the port's counterpart of
``tests/test_collective_audit.py``).

Numerical equality with one device cannot tell a decomposed run from one
that quietly replicates the work on every rank. The JAX package reads the
compiled HLO for that; here every collective goes through the logged
wrappers of ``parallel/world.py``, and ``parallel/dryrun.py::
dryrun_multichip`` returns each path's log and the shapes each rank held.
One gloo world of ``WORLD = 2`` ranks (as ``test_torch_parallel.py``) runs
the dry run's default setups at two sizes, 1 sim per rank over a 4-save
window and 4 sims per rank over a 12-save window, through
``tests/torch_parallel_worker.py``. The audit checks that:

- each rank holds ``S / N`` sims, members or rows;
- the data-parallel steps (NDE and embedded) issue one ``all_reduce`` of
  ``n_parameters + 7`` elements, the same at both sizes: communication
  independent of the batch and the window;
- the forward ensemble solvers issue no collective;
- the member-parallel step issues only the 7-scalar sum of the loss and
  its channels;
- the kernel search issues one ``all_gather``;
- the LES and the gyre exchange halo rows (one row for a y-shift, three for
  a WENO5 reconstruction) and use ``all_to_all`` (the LES's FFT transposes)
  or one 2-D ``all_reduce`` (the gyre's free surface) in their solves;
- neither ever moves a whole 3-D field: no ``all_gather``, every message
  smaller than the field.
"""

import pytest

import torch_parallel_worker as worker

from climateparameterizations_jl_tpu_torch.parallel import world

WORLD = 2
SIZES = ((1, 4), (4, 12))  # (sims per rank, saves per window)
NX = NZ = 8  # the dry run's LES and gyre: Nx = Nz = 8, Ny = 4 per rank


@pytest.fixture(scope="module")
def audit():
    return world.spawn_world(worker.audit_cases, WORLD, (tuple(s for s, _ in SIZES), tuple(w for _, w in SIZES)))[0]


def _ops(record):
    return [c["op"] for c in record["collectives"]]


@pytest.mark.parametrize("size", SIZES)
def test_each_rank_holds_its_share(audit, size):
    spr, n_save = size
    rec = audit[size]
    assert rec["nde_step"]["local"] == {"x0": (spr, 96), "targets": (spr, n_save + 1, 96)}
    assert rec["embedded_step"]["local"]["targets"] == (spr, n_save + 1, 96)
    assert rec["deep_ensemble_step"]["local"]["members"][0] == spr
    assert rec["ensemble_solver"]["local"] == {"x0": (spr, 96)}
    assert rec["les"]["local"] == {"T": (4, NX, NZ)}
    assert rec["gyre"]["local"] == {"T": (4, NX, NZ), "v": (5, NX, NZ)}


@pytest.mark.parametrize("path", ["nde_step", "embedded_step", "embedded_fc_step"])
def test_data_parallel_steps_reduce_o_parameters(audit, path):
    """One all_reduce per step, of the same size whatever the sims and the window."""
    logs = [audit[size][path]["collectives"] for size in SIZES]
    assert logs[0] == logs[1] and len(logs[0]) == 1
    (entry,) = logs[0]
    assert entry["op"] == "all_reduce" and entry["count"] == 1
    if path != "embedded_fc_step":
        assert entry["elements"] == audit["n_params"] + 7


@pytest.mark.parametrize("size", SIZES)
def test_ensemble_solvers_issue_no_collective(audit, size):
    assert audit[size]["ensemble_solver"]["collectives"] == []
    assert audit[size]["suite_ensemble_solver"]["collectives"] == []


@pytest.mark.parametrize("size", SIZES)
def test_member_parallel_step_sums_the_loss_only(audit, size):
    assert audit[size]["deep_ensemble_step"]["collectives"] == [{"op": "all_reduce", "elements": 7, "count": 1}]


@pytest.mark.parametrize("size", SIZES)
def test_kernel_search_gathers_once(audit, size):
    assert _ops(audit[size]["kernel_search"]) == ["all_gather"]
    assert audit[size]["kernel_search"]["collectives"][0]["count"] == 1


@pytest.mark.parametrize("path", ["les", "gyre"])
def test_fields_exchange_halos_not_fields(audit, path):
    field = 4 * WORLD * NX * NZ
    log = audit[SIZES[0]][path]["collectives"]
    ops = {c["op"] for c in log}
    assert "sendrecv" in ops and "all_gather" not in ops and "broadcast" not in ops
    assert ops - {"sendrecv"} == ({"all_to_all"} if path == "les" else {"all_reduce"})
    rows = set()
    for c in log:
        assert c["elements"] < field, c
        if c["op"] == "sendrecv":
            per_row = [k for k in (NX * NZ, NX * (NZ + 1), NX * (NZ - 1), NX, (NX + 1) * NZ) if c["elements"] % k == 0]
            assert per_row, c
            rows.add(c["elements"] // per_row[0])
    assert rows <= {1, 3} and 1 in rows and 3 in rows
    if path == "gyre":
        assert [c for c in log if c["op"] == "all_reduce"] == [{"op": "all_reduce", "elements": 4 * WORLD * NX,
                                                                "count": 1}]
    else:
        a2a = [c for c in log if c["op"] == "all_to_all"]
        assert sum(c["count"] for c in a2a) == 6  # two transposes per pressure solve, three solves per RK3 step
