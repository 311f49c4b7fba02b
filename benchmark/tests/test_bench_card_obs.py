"""The program's spans on the card, at the cell's small size: a traced run
reports the sketch layer's three metrics, and the spans share their clock
with the device trace (each K1 kernel starts after the ``sketch.draw`` span
that launched it opened).  ``python -m pytest benchmark/tests -m card -s``
on a machine with a CUDA card; skipped without one.

The clock check covers short runs only (3 passes over the small cell's
batches, well under a second).  Over a full 25 s window the profiler's
device timestamps can sit milliseconds off the host clock for seconds at
a time, and there some K1 kernels read as starting before their span
opened: the full-size property is known not to hold with the profiler's
single clock anchor (``DeviceProfile.mark``)."""

import math
import statistics

import pytest

from benchmark.harness import families, program_spans, runner, spec
from benchmark.harness import trace as tracing

from .sizes import TINY

CELL = "ont_sketch_k8_resident"
GPOS = [f"{s}_gpos_per_s" for s in ("kmers", "weights", "draw")]


@pytest.mark.card
def test_a_traced_run_on_the_card_reports_the_sketch_layer(card, tmp_path):
    res = runner.run_cell(CELL, 2**34 + 13, 1.0, True, device=card,
                          overrides=TINY[CELL], out_dir=str(tmp_path))
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in GPOS:
        assert math.isfinite(got[name]) and got[name] > 0
    assert "k1_roofline_pct" in got and "device_idle_pct" in got


@pytest.mark.card
def test_each_k1_kernel_starts_after_its_draw_span_opened(card, tmp_path):
    import torch
    cell = spec.cell(CELL, overrides=TINY[CELL])
    entry = cell.entry().Entry(runner.Context(cell, 2**34 + 15, card,
                                              str(tmp_path)))
    entry.inputs()
    entry.setup()
    entry.warm()
    tracer, prof = tracing.Tracer(), tracing.DeviceProfile()
    prof.start()
    program_spans.attach(tracer)
    try:
        prof.mark()
        for i in range(3 * len(entry.batches)):
            entry.job(i)
        entry.drain()
        torch.cuda.synchronize()
    finally:
        prof.stop()
        tracer.restore()
    dev, _ = prof.events()
    k1 = sorted(a for name, a, _ in dev
                if families.family(name) == families.K1
                and "tournament_kernel" in name)
    opened = sorted(a for n, a, _ in tracer.spans if n == "sketch.draw")
    assert len(k1) == len(opened) == 3 * len(entry.batches)
    lags = [(k - d) / 1e3 for k, d in zip(k1, opened)]
    print(f"K1 start after its sketch.draw span opened: median "
          f"{statistics.median(lags):.1f} us, min {min(lags):.1f} us over "
          f"{len(lags)} calls")
    assert min(lags) >= 0
