"""The readers of the engine loop's spans (``engine.step``'s phases and the
device gap) on synthetic readings: which spans each reads, the window, the
zero gaps counted, and nothing read where no span is; then a traced run of
the tiny benchmark on the CPU, which has the host phases and no device
gap."""

from __future__ import annotations

import json

import pytest

from portbench import readers, spec
from portbench.tests.conftest import ROOT, make_checkout
from portbench.tests.test_portbench_harness import run_cell

P50 = {
    "schedule_p50_ms": "engine.schedule",
    "enqueue_decode_p50_ms": "engine.enqueue_decode",
    "enqueue_prefill_p50_ms": "engine.enqueue_prefill",
    "postprocess_p50_ms": "engine.postprocess",
    "land_lag_p50_ms": "engine.land",
}
NEW = [*P50, "device_gap_ms"]


def _read(metric, spans, t0=10.0, t1=20.0):
    r = readers.Readings(shapes=None, arch=None, peaks=None, t0=t0, t1=t1,
                         results=[], spans=spans)
    return spec.reader(ROOT / "portbench", metric)(r)


@pytest.mark.parametrize("metric", sorted(P50))
def test_a_phase_median_reads_its_spans_that_began_in_the_window(metric):
    name = P50[metric]
    spans = [(name, 11.0, 11.001), (name, 12.0, 12.004),
             (name, 19.9995, 20.0025),        # began inside, ended after
             (name, 9.0, 10.5),               # began before the window
             (name, 20.5, 20.501),            # after it
             ("engine.step", 13.0, 14.0)]
    assert _read(metric, spans) == pytest.approx(3.0)
    assert _read(metric, [s for s in spans if s[0] != name]) is None
    assert _read(metric, []) is None


def test_device_gap_is_the_mean_of_the_gaps_that_ended_in_the_window():
    g = "engine.device_gap"
    spans = [(g, 11.0, 11.0), (g, 11.5, 11.5),        # queued: zero
             (g, 9.998, 10.002),                      # ended inside: 4 ms
             (g, 12.0, 12.008),                       # 8 ms
             (g, 19.999, 20.001),                     # ended after
             (g, 9.0, 9.5),                           # ended before
             ("engine.step", 11.0, 12.0)]
    assert _read("device_gap_ms", spans) == pytest.approx(3.0)
    assert _read("device_gap_ms", [(g, 11.0, 11.0)]) == 0.0
    assert _read("device_gap_ms", spans[-1:]) is None
    assert _read("device_gap_ms", []) is None


def test_every_new_metric_is_declared_for_the_cells_that_read_it():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    decode = ["mixtral8x7b-16L.decode-heavy", "mistral7b.decode-heavy"]
    prefill = ["mistral7b.prefill-heavy", "mixtral8x7b-16L.prefill-heavy"]
    for name in NEW:
        m = per_layer[name]
        assert (m["source"], m["unit"], m["better"]) == \
            ("program_span", "ms", "lower")
        want = prefill if name == "enqueue_prefill_p50_ms" else decode
        assert m["workloads"] == want
        assert m["moves"] == ("ttft_p50_ms" if m["workloads"] != decode
                              else "output_tok_s")
    # appended after the metrics the benchmark had
    assert set(list(per_layer)[-len(NEW):]) == set(NEW)


@pytest.mark.parametrize("name", ["tiny.open", "tiny.closed"])
def test_a_traced_cpu_run_reads_the_host_phases(tmp_path, capsys, name):
    root = make_checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] += [
        {"name": m, "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "test", "moves": "itl_p95_ms"} for m in NEW]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, line, _ = run_cell(root, name, capsys, trace=1)
    assert rc == 0 and line["correct"] is True
    got = line["metrics"]
    for m in ("schedule_p50_ms", "enqueue_decode_p50_ms",
              "postprocess_p50_ms", "land_lag_p50_ms"):
        assert got[m]["value"] >= 0 and got[m]["unit"] == "ms"
    if name == "tiny.open":
        assert got["enqueue_prefill_p50_ms"]["value"] > 0
    # no CUDA events on the CPU: no gap, and the metric is left out
    assert "device_gap_ms" not in got
