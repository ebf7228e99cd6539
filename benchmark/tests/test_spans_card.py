"""On the card: the untraced path keeps its launches once a stamped graph
has been captured beside it (``programs.launches_per_call`` reads 23 in
the traced sub-window's trace), and the stamped window of
``harness/spans.py`` reads every span metric, its stages summing to the
graph's span.  Skips without a CUDA card; run on the card with
``python -m pytest benchmark/tests -m card``."""

import pytest
import torch

from helpers import CELLS, HERE, SEED, bench

SPAN_METRICS = ("stage.detect_ms", "stage.nms_ms", "stage.mesh_ms",
                "stage.iris_ms", "stage.other_ms", "programs.launch_wait_ms",
                "programs.host_ms")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_untraced_launches_after_tracing(name, card):
    from harness import frames, trace
    from harness.core import TRACE_CALLS, Cell
    from tpu_face_torch.utils import profiling

    cell = Cell(bench(), name)
    pool = frames.make_pool(cell.traffic, HERE / "traffic", SEED, card)
    program = cell.entry.build(cell.config, card)

    def call(batch):
        return cell.entry.call(program, batch)

    call(pool[0])
    profiling.enable()
    call(pool[0])
    profiling.enable(False)
    summary = trace.profile(call, pool, TRACE_CALLS)
    assert sum(summary["launches"].values()) / TRACE_CALLS == 23
    assert len(cell.entry.programs(program)) == 2


@pytest.mark.card
def test_stamped_window_reads_every_span_metric(card):
    from harness import spans
    from harness.core import Cell

    cell = Cell(bench(), CELLS[0])
    ctx = {"config": cell.config, "traffic": dict(cell.traffic, batch=8)}
    got = {m: cell.reader(m)(ctx) for m in SPAN_METRICS}
    assert all(v is not None and v > 0 for v in got.values()), got
    stages = sum(got[m] for m in SPAN_METRICS[:5])
    assert stages == pytest.approx(
        spans.device_ms(ctx, (spans.GRAPH,)), rel=1e-6)
    w = ctx["spans"]["window"]
    assert w["seen"] == {"untraced": {"captures": 0, "builds": 0},
                         "stamped": {"captures": 0, "builds": 0}}
    assert all(c["error_ns"] <= 100_000
               for c in ctx["spans"]["clock"].values())
