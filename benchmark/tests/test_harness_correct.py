"""The comparison that decides ``correct``, on the CPU at a tiny size:
the program's plain path agrees with the reference, and the
lower-precision control and each fault a cascade cell can have (half of
the batch left out, an answer altered where it is produced) come out as
not correct.  The faults break the timed path underneath the harness,
which runs the rest of a run as it is."""

import pytest
import torch

from helpers import CELLS, run_tiny, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    result, checks = run_tiny(tiny_cell(name))
    assert result["correct"], checks
    assert list(result["checks"]) == list(checks)
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 2 and result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The program with its nets one precision lower (bf16 for the f32
    configurations)."""
    result, checks = run_tiny(tiny_cell(name, compute_dtype="bfloat16"))
    assert not result["correct"]
    failed = [n for n, (v, lim) in checks.items() if v > lim]
    assert failed, checks


def _broken(cell, fault):
    """The cell with its entry point's call broken by ``fault``."""
    call = cell.entry.call

    def broken(program, batch):
        return fault(call(program, batch), cell.traffic["width"])

    cell.entry = type("Entry", (), {})()
    for name in ("build", "programs", "with_face_axis", "compare"):
        setattr(cell.entry, name, getattr(__import__(
            "entries.face_cascade", fromlist=[name]), name))
    cell.entry.call = broken
    return cell


def _half_left_out(out, width):
    """The second half of the batch never computed: its rows copy the
    first half's."""
    n = out["score"].shape[0] // 2
    return {f: torch.cat([v[:n], v[:n]])[:v.shape[0]] if n else v
            for f, v in out.items()}


def _answer_altered(out, width):
    """One frame's refined mesh moved by three pixels."""
    out = dict(out)
    mesh = out["mesh"].clone()
    mesh[0, ..., 0] += 3.0 / width
    out["mesh"] = mesh
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_faults_are_not_correct(name, fault):
    result, checks = run_tiny(_broken(tiny_cell(name), fault))
    assert not result["correct"], (fault.__name__, checks)
