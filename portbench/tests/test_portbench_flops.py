"""The frozen arithmetic against hand counts at published widths, and the
readers that use it on made-up records and traces; the Mistral block's
leaves and counts pinned to what the harness read before they moved into
``arch/mistral.py``."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

from portbench import flops, readers, spec
from portbench.arch import mistral
from portbench.tests.conftest import ROOT
from portbench.trace import TraceSummary

H100 = flops.card_peaks("NVIDIA H100 80GB HBM3")


def shapes(name):
    return mistral.shapes(json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text()))


def test_one_mistral_layer_by_hand():
    s = shapes("mistral7b")
    # q and o: 4096 x 4096 each; k and v: 4096 x 1024 each (8 heads of
    # 128); gate, up and down: 4096 x 14336 each
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    ffn = 3 * 4096 * 14336
    assert mistral.layer_active_params(s) == attn + ffn == 218_103_808
    assert mistral.active_params(s) == 32 * 218_103_808 + 4096 * 32768
    assert mistral.token_flops(s) == 2 * (32 * 218_103_808 + 4096 * 32768)


def test_one_mixtral_layer_by_hand():
    s = shapes("mixtral8x7b-16L")
    attn = 2 * 4096 * 4096 + 2 * 4096 * 1024
    router = 4096 * 8
    experts = 2 * 3 * 4096 * 14336       # top-2 of 8
    assert mistral.layer_active_params(s) == attn + router + experts \
        == 394_297_344
    assert mistral.active_params(s) == 16 * 394_297_344 + 4096 * 32000


def test_attention_arithmetic_by_hand():
    s = shapes("mistral7b")
    # one decode row over 1,000 cached keys: K and V of 8 heads of 128 in
    # bf16, its query and output of 32 heads
    assert mistral.attn_launch_bytes(s, 1, 1000) \
        == 2 * 1000 * 8 * 128 * 2 + 2 * 32 * 128 * 2
    # a fresh 2,048-token chunk: causal context sum, QK^T and PV per layer
    ctx = flops.prefill_context_sum(0, 2048)
    assert ctx == 2048 * 2049 // 2
    assert mistral.attn_flops(s, ctx) == 4 * 32 * 32 * 128 * ctx
    bound = mistral.launch_bound_s(s, H100, 2048, 2048, ctx)
    assert bound == pytest.approx(4 * 32 * 128 * ctx / 989.4e12)


# What the harness read before the Mistral block moved into arch/: the
# leaves (name, shape, fan-in, in draw order) and, on PINNED_RECORDS,
# step_flops and attn_bound_s, as the parent's flops.py and readers.py
# computed them.
PINNED_RECORDS = [("decode", 64, 64, 64 * 900), ("decode", 7, 7, 12345),
                  ("prefill", 0, 2048, 2048 * 2049 // 2),
                  ("prefill", 0, 1000, 1000 * 3096 + 1000 * 1001 // 2),
                  ("prefill", 0, 16, 16 * 16 + 16 * 17 // 2)]
PINNED_BOUNDS = [7.073975402985075e-05, 1.5128300895522387e-05,
                 3.474481057610673e-05, 5.9556353345461896e-05,
                 1.1737791044776119e-07]
PINNED = {
    "mistral7b.prefill-heavy": (
        [("embed", (32768, 4096), 4096), ("layers/attn_norm", (32, 4096), 0),
         ("layers/wq", (32, 4096, 4096), 4096),
         ("layers/wk", (32, 4096, 1024), 4096),
         ("layers/wv", (32, 4096, 1024), 4096),
         ("layers/wo", (32, 4096, 4096), 4096),
         ("layers/mlp_norm", (32, 4096), 0),
         ("layers/w_gate", (32, 4096, 14336), 4096),
         ("layers/w_up", (32, 4096, 14336), 4096),
         ("layers/w_down", (32, 14336, 4096), 14336),
         ("final_norm", (4096,), 0), ("lm_head", (4096, 32768), 4096)],
        [940732055552.0, 106061889536.0, 30237106634752.0,
         16112680960000.0, 227838787584.0]),
    "mixtral8x7b-16L.decode-heavy": (
        [("embed", (32000, 4096), 4096), ("layers/attn_norm", (16, 4096), 0),
         ("layers/wq", (16, 4096, 4096), 4096),
         ("layers/wk", (16, 4096, 1024), 4096),
         ("layers/wv", (16, 4096, 1024), 4096),
         ("layers/wo", (16, 4096, 4096), 4096),
         ("layers/mlp_norm", (16, 4096), 0),
         ("layers/w_router", (16, 4096, 8), 4096),
         ("layers/w_gate", (16, 8, 4096, 14336), 4096),
         ("layers/w_up", (16, 8, 4096, 14336), 4096),
         ("layers/w_down", (16, 8, 14336, 4096), 14336),
         ("final_norm", (4096,), 0), ("lm_head", (4096, 32000), 4096)],
        [839397670912.0, 93393780736.0, 26927565897728.0,
         13822459904000.0, 206177304576.0]),
}


@pytest.mark.parametrize("cell", sorted(PINNED))
def test_the_moved_counts_read_as_before(cell):
    """The architecture found by the configuration's ``model_type`` gives
    the leaves, FLOPs and attention bounds the harness gave before they
    moved, bit for bit."""
    c = spec.load(ROOT, cell)
    arch = spec.arch(c.bench_dir, c.config)
    s = arch.shapes(c.config)
    leaves, step = PINNED[cell]
    assert list(arch.leaf_shapes(s)) == leaves
    recs = [SimpleNamespace(kind=k, live_rows=rows, real_tokens=n,
                            context_sum=ctx)
            for k, rows, n, ctx in PINNED_RECORDS]
    assert [arch.step_flops(s, x) for x in recs] == step
    assert [arch.attn_bound_s(s, H100, x) for x in recs] == PINNED_BOUNDS


def test_unknown_card_has_no_peak():
    assert flops.card_peaks("NVIDIA A100-SXM4-80GB") is None
    assert flops.card_peaks("cpu") is None


def rec(kind, t, rows=0, tokens=0, ctx=0):
    return SimpleNamespace(kind=kind, t_dispatch=t, t_land=t + 0.01,
                           live_rows=rows, real_tokens=tokens,
                           context_sum=ctx)


def test_readers_on_made_up_runs():
    s = shapes("mistral7b")
    recs = [rec("decode", 1.0, rows=64, tokens=64, ctx=64 * 900),
            rec("decode", 1.5, rows=32, tokens=32, ctx=32 * 900),
            rec("prefill", 2.0, tokens=2048,
                ctx=flops.prefill_context_sum(512, 2048))]
    trace = TraceSummary(
        t_start=0.5, t_stop=3.0, busy_s=2.0, window_s=2.5, device_ops=[],
        idle_gaps=[], graph_windows_s=[0.012, 0.014],
        kernel_time={"decode": (64 * 0.0001, 64),
                     "ragged": (32 * 0.0002, 32)})
    r = readers.Readings(shapes=s, arch=mistral, peaks=H100, t0=0.0, t1=4.0,
                         results=[], spans=[("worker.queue", 0.5, 0.6),
                                ("worker.queue", 1.0, 1.3),
                                ("worker.queue", 5.0, 5.1)],
                         records=recs, trace=trace)
    assert readers.span_p50_ms(r, "worker.queue") == pytest.approx(100.0)
    assert readers.decode_batch_mean(r) == 48
    assert readers.decode_window_ms(r) == pytest.approx(13.0)
    assert readers.idle_pct(r) == pytest.approx(20.0)
    work = sum(mistral.step_flops(s, x) for x in recs)
    assert readers.mfu_pct(r) == pytest.approx(
        100 * work / (4.0 * 989.4e12))
    # the decode face: the mean bound of the two windows' launches over
    # the mean launch time
    bounds = [mistral.launch_bound_s(s, H100, n, n * 900, n * 900)
              for n in (64, 32)]
    assert readers.roofline_pct(r, "decode") == pytest.approx(
        100 * sum(bounds) / 2 / 0.0001)
    ragged = mistral.launch_bound_s(s, H100, 2048, 2560,
                                    flops.prefill_context_sum(512, 2048))
    assert readers.roofline_pct(r, "ragged") == pytest.approx(
        100 * ragged / 0.0002)
    # nothing to read: no trace, no card peaks
    bare = readers.Readings(shapes=s, arch=mistral, peaks=None, t0=0.0,
                            t1=4.0, results=[])
    for read in (readers.decode_window_ms, readers.idle_pct,
                 readers.mfu_pct, readers.decode_batch_mean):
        assert read(bare) is None
    assert readers.roofline_pct(bare, "decode") is None


def test_percentile_is_nearest_rank():
    assert readers.percentile([5, 1, 4, 2, 3], 50) == 3
    assert readers.percentile(list(range(1, 101)), 95) == 95
    assert readers.percentile([], 95) is None


class _Ev:
    """A raw profiler event as ``trace.py`` reads it."""

    def __init__(self, name, start_us, end_us, corr, cuda):
        self._v = (name, start_us, end_us, corr, cuda)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(self._v[1] * 1000)

    def end_ns(self):
        return int(self._v[2] * 1000)

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[4] else DeviceType.CPU


def test_trace_reduction_on_made_up_events():
    from portbench.trace import DeviceTrace

    events = [
        # two graph replays of two kernels each, one cut by the trace's end
        _Ev("cudaGraphLaunch", 0, 5, 1, False),
        _Ev("gemm", 10, 20, 1, True),
        _Ev("paged_attention_decode_split_kernel<bf16>", 20, 24, 1, True),
        _Ev("cudaGraphLaunch", 30, 35, 2, False),
        _Ev("gemm", 40, 50, 2, True),
        _Ev("paged_attention_decode_split_kernel<bf16>", 50, 56, 2, True),
        _Ev("cudaLaunchKernel", 60, 61, 3, False),
        _Ev("ragged_paged_attention_mma_kernel<bf16>", 100, 130, 3, True),
        _Ev("cudaGraphLaunch", 140, 141, 4, False),
        _Ev("gemm", 150, 160, 4, True),
    ]
    dt = DeviceTrace()
    dt._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    dt.t_start, dt.t_stop = 0.0, 200e-6
    s = dt.summary()
    assert s.busy_s == pytest.approx((14 + 16 + 30 + 10) * 1e-6)
    assert s.window_s == pytest.approx(200e-6)
    assert s.graph_windows_s == pytest.approx([14e-6, 16e-6])
    assert s.kernel_time["decode"] == (pytest.approx(10e-6), 2)
    assert s.kernel_time["ragged"] == (pytest.approx(30e-6), 1)
    # the longest idle gap ended when the host launched the ragged kernel
    assert s.idle_gaps[0] == ("cudaLaunchKernel", pytest.approx(44e-6))
    assert s.device_ops[0] == ("gemm", pytest.approx(30e-6))
