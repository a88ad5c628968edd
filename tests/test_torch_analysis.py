"""The port's dynalint (``dynamo_tpu_torch.analysis``) against the JAX
package's (``dynamo_tpu.analysis``).

- Framework-neutral fixtures (DT001, the suppression comments, DT301–DT303,
  the baseline's fingerprints, counts and stale entries, the CLI's exit
  codes and ``--format json``) go through both analyzers and must give the
  same ``(code, line, col, symbol, message)``.
- Each JAX fixture of ``tests/test_analysis.py`` for DT1xx, DT2xx, DT4xx and
  DT5xx has a torch twin written line for line (``jax.device_get(x)`` ↔
  ``x.cpu()``, a ``jax.jit`` in a loop ↔ a ``torch.compile`` in a loop, a
  BlockSpec arity slip ↔ an ``argtypes`` one against a ``.cu`` snippet): the
  port's rule fires at the JAX rule's lines with its code, and is quiet
  where the JAX fixture is.
- The real package lints clean modulo its committed baseline (at most 7
  entries), an injected violation fails the CLI, and the real ``ctypes``
  bindings agree with ``csrc/`` while a copy with one ``argtypes`` entry
  dropped does not.
"""

from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from dynamo_tpu import analysis as ja
from dynamo_tpu.analysis.__main__ import main as jmain
from dynamo_tpu_torch import analysis as ta
from dynamo_tpu_torch.analysis.__main__ import main as tmain
from dynamo_tpu_torch.analysis.baseline import DEFAULT_BASELINE
from dynamo_tpu_torch.analysis.rules_kernels import parse_extern_c
from dynamo_tpu_torch.utils.hotpath import hot_path

pytestmark = pytest.mark.analysis

ROOT = Path(__file__).resolve().parent.parent
NEUTRAL = "pkg/fixture.py"                  # cold for both analyzers
JHOT, THOT = "dynamo_tpu/ops/fixture.py", "dynamo_tpu_torch/ops/fixture.py"
JCOLD, TCOLD = "dynamo_tpu/llm/fixture.py", "dynamo_tpu_torch/llm/fixture.py"
JLAYOUT = "dynamo_tpu/parallel/layout.py"
TLAYOUT = "dynamo_tpu_torch/parallel/layout.py"
TCOMM = "dynamo_tpu_torch/parallel/comm.py"


def jlint(src, path=JCOLD, select=None):
    rules = ja.rules_for(select) if select else ja.ALL_RULES
    return ja.analyze_source(textwrap.dedent(src), path, rules)


def tlint(src, path=TCOLD, select=None, config=None):
    rules = ta.rules_for(select) if select else ta.ALL_RULES
    return ta.analyze_source(textwrap.dedent(src), path, rules, config)


def full(findings):
    return [(f.code, f.line, f.col, f.symbol, f.message) for f in findings]


def at(findings):
    return [(f.code, f.line) for f in findings]


# ---------------------------------------------------------------------------
# framework-neutral fixtures: identical findings

BAD_ASYNC = """
import asyncio

async def serve(work):
    asyncio.create_task(work())
"""

NEUTRAL_CASES = {
    "dt001-syntax": ("def f(:\n    pass\n", None, ["DT001"]),
    "suppress-same-and-next-line": ("""
        import asyncio
        async def serve(work):
            asyncio.create_task(work())  # dynalint: disable=DT302
            # dynalint: disable-next-line=DT302
            asyncio.create_task(work())
        """, None, []),
    "suppress-all": ("""
        import asyncio
        async def serve(work):
            asyncio.create_task(work())  # dynalint: disable=all
        """, None, []),
    "suppress-code-specific": ("""
        import asyncio, time
        async def serve(work):
            time.sleep(1); asyncio.create_task(work())  # dynalint: disable=DT301
        """, None, ["DT302"]),
    "dt301-blocking": ("""
        import asyncio
        import time

        async def poll():
            time.sleep(0.5)
        """, ["DT301"], ["DT301"]),
    "dt301-sync-quiet": ("import time\ndef poll():\n    time.sleep(0.5)\n",
                         ["DT301"], []),
    "dt302-statement-and-lambda": ("""
        import asyncio

        async def serve(loop, shutdown):
            asyncio.create_task(shutdown())
            loop.add_signal_handler(2, lambda: asyncio.ensure_future(shutdown()))
        """, ["DT302"], ["DT302", "DT302"]),
    "dt302-unused-handle": ("""
        import asyncio

        async def serve(work):
            t = asyncio.create_task(work())
        """, ["DT302"], ["DT302"]),
    "dt302-kept-quiet": ("""
        import asyncio

        async def serve(work, registry):
            t = asyncio.create_task(work())
            registry.add(t)
            await asyncio.create_task(work())
        """, ["DT302"], []),
    "dt303-bare-except": ("""
        async def pump(stream):
            try:
                await stream.next()
            except:
                pass
        """, ["DT303"], ["DT303"]),
    "dt303-base-exception": ("""
        async def pump(stream):
            try:
                await stream.next()
            except BaseException as e:
                log(e)
        """, ["DT303"], ["DT303"]),
    "dt303-quiet": ("""
        import asyncio

        async def pump(stream, task):
            try:
                await stream.next()
            except Exception:
                pass
            try:
                await stream.next()
            except BaseException:
                raise
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        """, ["DT303"], []),
    "all-rules-on-async": (BAD_ASYNC, None, ["DT302"]),
}


@pytest.mark.parametrize("case", sorted(NEUTRAL_CASES))
def test_neutral_fixture_gives_the_same_findings(case):
    src, select, want = NEUTRAL_CASES[case]
    j = jlint(src, NEUTRAL, select)
    t = tlint(src, NEUTRAL, select)
    assert sorted(f.code for f in j) == want
    assert full(t) == full(j)
    assert [f.snippet for f in t] == [f.snippet for f in j]


def test_registries_carry_the_same_codes():
    assert [r.code for r in ta.ALL_RULES] == [r.code for r in ja.ALL_RULES]
    assert {r.code[:3] for r in ta.ALL_RULES} == {
        "DT1", "DT2", "DT3", "DT4", "DT5"}
    for sel in (["DT3"], ["DT302"], ["DT1"], ["DT40"]):
        assert [r.code for r in ta.rules_for(sel)] == [
            r.code for r in ja.rules_for(sel)]
    with pytest.raises(ValueError):
        ta.rules_for(["DT999"])


def test_baseline_fingerprints_counts_and_stale_entries(tmp_path):
    jf, tf = jlint(BAD_ASYNC, NEUTRAL), tlint(BAD_ASYNC, NEUTRAL)
    assert [ja.fingerprint(f) for f in jf] == [ta.fingerprint(f) for f in tf]
    shifted = "# a new comment line\n" + BAD_ASYNC
    a, b = tlint(BAD_ASYNC, NEUTRAL)[0], tlint(shifted, NEUTRAL)[0]
    assert a.line != b.line and ta.fingerprint(a) == ta.fingerprint(b)
    doubled = BAD_ASYNC + "\n\nasync def serve2(work):\n" \
        "    asyncio.create_task(work())\n"
    for pkg, lint in ((ja, jlint), (ta, tlint)):
        base = pkg.Baseline.from_findings(lint(BAD_ASYNC, NEUTRAL))
        new, old, stale = base.partition(lint(doubled, NEUTRAL))
        assert (len(new), len(old), stale) == (1, 1, 0)
        path = tmp_path / f"{pkg.__name__}.json"
        base.save(path)
        assert pkg.Baseline.load(path).partition([]) == ([], [], 1)
    rows = [json.loads((tmp_path / f"{p.__name__}.json").read_text())
            ["findings"] for p in (ja, ta)]
    assert rows[0] == rows[1]


def test_cli_exit_codes_and_json_equal_jax(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_ASYNC, encoding="utf-8")
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n", encoding="utf-8")
    outs = []
    for main in (jmain, tmain):
        codes = [main([str(bad), "--check", "--no-baseline"]),
                 main([str(good), "--check", "--no-baseline"]),
                 main([str(bad), "--select", "DT4", "--no-baseline"]),
                 main(["--select", "DT999"])]
        capsys.readouterr()
        assert main([str(bad), "--format", "json", "--no-baseline"]) == 1
        outs.append((codes, json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]
    assert outs[1][0] == [1, 0, 0, 2]
    assert outs[1][1]["new"][0]["code"] == "DT302"


def test_cli_list_rules(capsys):
    assert tmain(["--list-rules"]) == 0
    listing = capsys.readouterr().out
    for rule in ta.ALL_RULES:
        assert rule.code in listing


def test_hot_path_is_a_runtime_noop():
    @hot_path
    def f(x):
        return x + 1

    assert f(1) == 2
    assert f.__dynalint_hot_path__ is True


# ---------------------------------------------------------------------------
# twins: the JAX fixture and its torch counterpart, line for line.
# (name, JAX source, its path, torch source, its path, select, codes)

TWINS = [
    ("dt101-item-and-int", """
        import jax
        def step(tok):
            return tok.item(), int(jax.device_put(tok))
        """, JHOT, """
        import torch
        def step(tok):
            return tok.item(), int(torch.as_tensor(tok))
        """, THOT, ["DT101"], ["DT101", "DT101"]),
    ("dt101-hot-path-decorator", """
        import jax
        from dynamo_tpu.utils.hotpath import hot_path

        @hot_path
        def step(tok):
            return tok.item()
        """, JCOLD, """
        import torch
        from dynamo_tpu_torch.utils.hotpath import hot_path

        @hot_path
        def step(tok):
            return tok.item()
        """, TCOLD, ["DT101"], ["DT101"]),
    ("dt101-quiet-cold", """
        import jax
        def load_checkpoint(x):
            return x.item()
        """, JCOLD, """
        import torch
        def load_checkpoint(x):
            return x.item()
        """, TCOLD, ["DT101"], []),
    ("dt101-quiet-module-level", "import jax\nx = 1\ny = int(x)\n", JHOT,
     "import torch\nx = 1\ny = int(x)\n", THOT, ["DT101"], []),
    ("dt102-transfers", """
        import jax
        import numpy as np
        def step(tok):
            a = jax.device_get(tok)
            b = np.asarray(jax.device_put(tok))
            tok.block_until_ready()
            return a, b
        """, JHOT, """
        import torch
        import numpy as np
        def step(tok):
            a = tok.cpu()
            b = np.asarray(torch.as_tensor(tok))
            torch.cuda.synchronize()
            return a, b
        """, THOT, ["DT102"], ["DT102"] * 3),
    ("dt102-quiet-host-numpy", """
        import numpy as np
        def step(rows):
            return np.asarray(rows)
        """, JHOT, """
        import numpy as np
        def step(rows):
            return np.asarray(rows)
        """, THOT, ["DT102"], []),
    ("dt103-missing", """
        import jax
        @jax.jit
        def step(params, cache, tokens):
            return cache, tokens
        """, JHOT, """
        import torch
        def step(params, cache, tokens):
            cache = cache.index_copy(0, tokens, params)
            return cache, tokens
        """, THOT, ["DT103"], ["DT103"]),
    ("dt103-quiet-donated-or-in-place", """
        import jax
        @functools.partial(jax.jit, donate_argnums=(1,))
        def step(params, cache, tokens):
            return cache, tokens

        def make(cfg):
            def window(params, cache, ctl, rows):
                return cache, ctl
            return jax.jit(window, donate_argnames=("cache", "ctl"))
        """, JHOT, """
        import torch
        def step(params, cache, tokens):
            cache.index_copy_(0, tokens, params)
            return cache, tokens

        def make(cfg):
            def window(params, cache, ctl, rows):
                return cache, ctl
            return window
        """, THOT, ["DT103"], []),
    ("dt103-entry-of-a-buffer", """
        import jax
        def raw_window_fn(cfg, eng):
            def window(params, cache, ctl, rows):
                return cache, ctl
            return window

        def make_window_fn(cfg, eng):
            return jax.jit(raw_window_fn(cfg, eng), donate_argnums=(1,))
        """, JHOT, """
        import torch
        def raw_window_fn(cfg, eng):
            def window(params, cache, ctl, rows):
                return cache, ctl
            return window

        def make_window_fn(cfg, eng, ctl, rows):
            ctl["ctr"] = ctl["ctr"].index_copy(0, rows, rows)
        """, THOT, ["DT103"], ["DT103"]),
    ("dt103-waived", """
        import jax
        def make(cfg):
            def extract(cache, ids):
                return cache
            return jax.jit(extract)  # dynalint: disable=DT103
        """, JHOT, """
        import torch
        def make(cfg):
            def extract(cache, ids):
                return cache
            cache = cfg.clone()  # dynalint: disable=DT103
        """, THOT, ["DT103"], []),
    ("dt103-quiet-other-name-and-cold", """
        import jax
        @jax.jit
        def step(params, cache):
            return cache
        """, JCOLD, """
        import torch
        def step(params, cache):
            cache = cache.clone()
            return cache
        """, TCOLD, ["DT103"], []),
    ("dt201-mutable-global", """
        import jax
        CACHE = {}

        @jax.jit
        def f(x):
            return CACHE["scale"] * x
        """, JCOLD, """
        import torch
        CACHE = {}

        @torch.compile
        def f(x):
            return CACHE["scale"] * x
        """, TCOLD, ["DT201"], ["DT201"]),
    ("dt201-quiet-parameter", """
        import jax
        CACHE = {}

        @jax.jit
        def f(x, cache):
            return cache["scale"] * x

        y = f(1.0, CACHE)
        """, JCOLD, """
        import torch
        CACHE = {}

        @torch.compile
        def f(x, cache):
            return cache["scale"] * x

        y = f(1.0, CACHE)
        """, TCOLD, ["DT201"], []),
    ("dt202-branch", """
        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
        """, JCOLD, """
        import torch

        @torch.compile
        def f(x):
            if x > 0:
                return x
            return -x
        """, TCOLD, ["DT202"], ["DT202"]),
    ("dt202-quiet-static-shape-none", """
        import jax
        from functools import partial

        @partial(jax.jit, static_argnames=("n",))
        def f(x, n, mask=None):
            if n > 4 and x.shape[0] > 8 and mask is None:
                return x
            return -x
        """, JCOLD, """
        import torch
        from functools import partial

        @torch.compile
        def f(x, n: int, mask=None):
            if n > 4 and x.shape[0] > 8 and mask is None:
                return x
            return -x
        """, TCOLD, ["DT202"], []),
    ("dt202-quiet-partial-bound", """
        import jax
        import functools

        def kernel(cfg, x):
            if cfg > 0:
                return x
            return -x

        step = jax.jit(functools.partial(kernel, 4))
        """, JCOLD, """
        import torch
        import functools

        def kernel(cfg, x):
            if cfg > 0:
                return x
            return -x

        step = torch.compile(functools.partial(kernel, 4))
        """, TCOLD, ["DT202"], []),
    ("dt203-in-loop", """
        import jax
        def run(fns, xs):
            outs = []
            for fn in fns:
                outs.append(jax.jit(fn)(xs))
            return outs
        """, JCOLD, """
        import torch
        def run(fns, xs):
            outs = []
            for fn in fns:
                outs.append(torch.compile(fn)(xs))
            return outs
        """, TCOLD, ["DT203"], ["DT203"]),
    ("dt203-quiet-hoisted", """
        import jax
        def run(fns, xs):
            jitted = [jax.jit(fn) for fn in fns]
            return [fn(xs) for fn in jitted]
        """, JCOLD, """
        import torch
        def run(fns, xs):
            graphs = [torch.cuda.CUDAGraph() for fn in fns]
            return [fn(xs) for fn in graphs]
        """, TCOLD, ["DT203"], []),
    ("dt401-kind", """
        from jax.experimental import pallas as pl

        spec = pl.BlockSpec((8, 128), lambda i, j: print(i))
        """, JCOLD, """
        import ctypes

        lib.dtt_f.argtypes = [ctypes.c_void_p, ctypes.c_float]
        """, TCOLD, ["DT401"], ["DT401"]),
    ("dt401-quiet", """
        from jax.experimental import pallas as pl

        spec = pl.BlockSpec((8, 128), lambda i, j: (i, 0))
        """, JCOLD, """
        import ctypes

        lib.dtt_f.argtypes = [ctypes.c_void_p, ctypes.c_int]
        """, TCOLD, ["DT401"], []),
    ("dt402-argtypes-length", """
        from jax.experimental.pallas import tpu as pltpu
        from jax.experimental import pallas as pl

        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(4, 8),
            in_specs=[pl.BlockSpec((8, 128), lambda i, j: (i, j))],
        )
        """, JCOLD, """
        import ctypes
        from ctypes import c_void_p as _P

        N_PTR = 2
        N_INT = 4
        # one int short of dtt_g's
        lib.dtt_g.argtypes = [_P] * N_PTR + [ctypes.c_int] * (N_INT - 1)

        """, TCOLD, ["DT402"], ["DT402"]),
    ("dt402-quiet", """
        from jax.experimental.pallas import tpu as pltpu
        from jax.experimental import pallas as pl

        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2,
            grid=(4, 8),
            in_specs=[pl.BlockSpec((8, 128), lambda s0, s1, i, j: (i, j))],
        )
        """, JCOLD, """
        import ctypes
        from ctypes import c_void_p as _P

        N_PTR = 2
        N_INT = 4
        # as many as dtt_g's
        lib.dtt_g.argtypes = [_P] * N_PTR + [ctypes.c_int] * N_INT

        """, TCOLD, ["DT402"], []),
    ("dt402-call-arity", """
        from jax.experimental import pallas as pl

        out = pl.pallas_call(
            kernel,
            grid=(4,),
            in_specs=[pl.BlockSpec((128,), lambda i, j: (i,))],
        )
        """, JCOLD, """
        import ctypes

        lib = ctypes.CDLL("libk.so")
        lib.dtt_f.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dtt_f.restype = ctypes.c_int
        err = lib.dtt_f(ptr, n, stream)
        """, TCOLD, ["DT402"], ["DT402"]),
    ("dt501-literal", """
        from jax.sharding import PartitionSpec as P

        def shardings():
            return P(None, "tp")
        """, JCOLD, """
        from dynamo_tpu_torch.parallel.layout import spec

        def shardings():
            return spec(None, "tp")
        """, TCOLD, ["DT501"], ["DT501"]),
    ("dt501-quiet-constant", """
        from jax.sharding import PartitionSpec as P
        from dynamo_tpu.parallel.layout import AXIS_TP

        def shardings():
            return P(None, AXIS_TP)
        """, JCOLD, """
        from dynamo_tpu_torch.parallel.layout import spec
        from dynamo_tpu_torch.parallel.layout import AXIS_TP

        def shardings():
            return spec(None, AXIS_TP)
        """, TCOLD, ["DT501"], []),
    ("dt501-quiet-layout-module", """
        from jax.sharding import PartitionSpec as P
        SPEC = P(None, "tp")
        """, JLAYOUT, """
        SPEC = spec(None, "tp")
        """, TLAYOUT, ["DT501"], []),
    ("dt502-mesh", """
        from jax.sharding import Mesh

        def make(devices):
            return Mesh(devices, ("dp",))
        """, JCOLD, """
        from dynamo_tpu_torch.parallel.layout import Mesh

        def make(devices):
            return Mesh({"dp": 1}, {"dp": 0})
        """, TCOLD, ["DT502"], ["DT502"]),
    ("dt502-quiet-layout", """
        from jax.sharding import Mesh

        def make(devices):
            return Mesh(devices, ("dp",))
        """, JLAYOUT, """
        from dynamo_tpu_torch.parallel.layout import Mesh

        def make(devices):
            return Mesh({"dp": 1}, {"dp": 0})
        """, TLAYOUT, ["DT502"], []),
    ("dt503-axis-carrying", """
        from jax.sharding import PartitionSpec as P
        from dynamo_tpu.parallel.layout import AXIS_TP

        def shardings():
            return P(None, AXIS_TP)
        """, JCOLD, """
        from dynamo_tpu_torch.parallel.layout import spec
        from dynamo_tpu_torch.parallel.layout import AXIS_TP

        def shardings():
            return spec(None, AXIS_TP)
        """, TCOLD, ["DT503"], ["DT503"]),
    ("dt503-quiet-replicated", """
        from jax.sharding import PartitionSpec as P

        A = P()
        B = P(None, None)
        """, JCOLD, """
        from dynamo_tpu_torch.parallel.layout import spec

        A = spec()
        B = spec(None, None)
        """, TCOLD, ["DT503"], []),
    ("dt503-quiet-layout", """
        from jax.sharding import PartitionSpec as P
        SPEC = P(None, "tp")
        """, JLAYOUT, """
        SPEC = spec(None, "tp")
        """, TLAYOUT, ["DT503"], []),
    ("dt503-suppressed", """
        from jax.sharding import PartitionSpec as P

        SPEC = P(None, "tp")  # dynalint: disable=DT503
        """, JCOLD, """
        from dynamo_tpu_torch.parallel.layout import spec

        SPEC = spec(None, "tp")  # dynalint: disable=DT503
        """, TCOLD, ["DT503"], []),
    ("suppressed-transfer", """
        import jax
        def step(tok):
            a = jax.device_get(tok)  # dynalint: disable=DT102
            # dynalint: disable-next-line=DT102
            b = jax.device_get(tok)
            return a, b
        """, JHOT, """
        import torch
        def step(tok):
            a = tok.cpu()  # dynalint: disable=DT102
            # dynalint: disable-next-line=DT102
            b = tok.cpu()
            return a, b
        """, THOT, None, []),
    ("suppression-code-specific", """
        import jax
        def step(tok):
            return jax.device_get(tok)  # dynalint: disable=DT101
        """, JHOT, """
        import torch
        def step(tok):
            return tok.cpu()  # dynalint: disable=DT101
        """, THOT, None, ["DT102"]),
]

# the C entry points the DT4xx twins bind
FIXTURE_CU = """
// a kernel's plain C interface
extern "C" int dtt_f(const void* p, int n) { return n; }

extern "C" {
int dtt_g(void* a, void* b, int c, int d, int e,
          int64_t f) {
  if (c) { return 1; }
  return 0;
}
}  // extern "C"
"""


@pytest.fixture
def kernel_root(tmp_path):
    csrc = tmp_path / "dynamo_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "fixture.cu").write_text(FIXTURE_CU)
    return ta.AnalysisConfig(root=tmp_path)


@pytest.mark.parametrize("twin", TWINS, ids=[t[0] for t in TWINS])
def test_twin_fires_where_jax_fires(twin, kernel_root):
    _, jsrc, jpath, tsrc, tpath, select, want = twin
    j = jlint(jsrc, jpath, select)
    t = tlint(tsrc, tpath, select, kernel_root)
    assert sorted(f.code for f in j) == want
    assert at(t) == at(j), [f.render() for f in t]


def test_twin_messages_name_what_they_found(kernel_root):
    by = {t[0]: t for t in TWINS}
    _, _, _, src, path, sel, _ = by["dt103-entry-of-a-buffer"]
    f, = tlint(src, path, sel, kernel_root)
    assert "`ctl`" in f.message and "index_copy_" in f.message
    assert "index_copy" in f.snippet
    _, _, _, src, path, sel, _ = by["dt402-argtypes-length"]
    f, = tlint(src, path, sel, kernel_root)
    assert "has 5 entries" in f.message and "takes 6" in f.message
    _, _, _, src, path, sel, _ = by["dt401-kind"]
    f, = tlint(src, path, sel, kernel_root)
    assert "argtypes[1] of `dtt_f` is float" in f.message
    assert parse_extern_c(FIXTURE_CU) == {
        "dtt_f": ["pointer", "int"],
        "dtt_g": ["pointer", "pointer", "int", "int", "int", "int"]}


# ---------------------------------------------------------------------------
# torch-only shapes of the same hazards


def test_dt102_torch_transfers_and_one_report_per_copy():
    src = """
    import torch
    def step(tok, evt, stream):
        a = tok.to("cpu")
        b = tok.to(device=torch.device("cpu"))
        evt.synchronize()
        stream.synchronize()
        c = tok.cpu().numpy()
        d = tok.to("cuda")
        return a, b, c, d
    """
    found = tlint(src, THOT, ["DT102"])
    assert [f.line for f in found] == [4, 5, 6, 7, 8]


def test_dt202_graph_capture_body_is_a_capture_target():
    src = """
    import torch

    def body(x, n: int):
        if x.sum() > 0 and n > 2:
            return x
        return -x

    def capture(g, x):
        with torch.cuda.graph(g):
            body(x, 3)
    """
    found = tlint(src, TCOLD, ["DT202"])
    assert at(found) == [("DT202", 5)] and "`x`" in found[0].message


def test_dt201_dt203_graphs_and_globals():
    src = """
    import torch
    STATE = []

    def step(x):
        return x + len(STATE)

    def capture_all(xs):
        for x in xs:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                step(x)
        fns = torch.cuda.make_graphed_callables((step,), (xs,))
    """
    assert at(tlint(src, TCOLD, ["DT2"])) == [
        ("DT201", 6), ("DT203", 10), ("DT203", 11)]


def test_dt5xx_process_groups_axis_keywords_and_dict_keys():
    src = """
    import torch.distributed as dist

    def setup(ctl, ranks):
        dist.init_process_group("gloo", rank=0, world_size=1)
        g = dist.new_group(ranks)
        top_p = ctl["tp"]
        return reduce(g, axis="tp"), spec(ctl["tp"])
    """
    # the axis keyword is one DT501; the top-p key inside spec() is none
    # (the spec is still axis-carrying: DT503, as any non-None entry)
    assert at(tlint(src, TCOLD, ["DT5"])) == [
        ("DT502", 5), ("DT502", 6), ("DT501", 8), ("DT503", 8)]
    assert tlint(src, TCOMM, ["DT502"]) == []


# ---------------------------------------------------------------------------
# the real package


def test_repo_is_clean_modulo_committed_baseline(capsys):
    assert tmain(["--check"]) == 0
    out = capsys.readouterr().out
    assert "0 new finding(s)" in out and "0 stale" in out


def test_committed_baseline_never_grows():
    assert DEFAULT_BASELINE.parent == ROOT / "dynamo_tpu_torch" / "analysis"
    baseline = ta.Baseline.load(DEFAULT_BASELINE)
    # grandfathered where the JAX baseline holds the same functions (the
    # embed and KV-extract slow paths); shrink it, never regrow it
    assert 0 < baseline.total <= 7
    assert {s for _, _, s, _ in baseline.entries} <= {
        "InferenceEngine.embed._run",
        "InferenceEngine.extract_kv_blocks._ex"}


def test_cli_fails_on_injected_violation(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD_ASYNC, encoding="utf-8")
    assert tmain([str(bad), "--check"]) == 1
    assert "DT302" in capsys.readouterr().out


BINDINGS = ["dynamo_tpu_torch/ops/paged_attention.py",
            "dynamo_tpu_torch/native/__init__.py"]
DROPS = {
    BINDINGS[0]: ("fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]",
                  "fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]"),
    BINDINGS[1]: ("_P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, "
                  "_P, _P]",
                  "_P, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, "
                  "_P]"),
}


@pytest.mark.parametrize("path", BINDINGS)
def test_real_bindings_agree_with_csrc(path):
    cfg = ta.AnalysisConfig(root=ROOT)
    src = (ROOT / path).read_text(encoding="utf-8")
    rules = ta.rules_for(["DT4"])
    assert ta.analyze_source(src, path, rules, cfg) == []
    old, new = DROPS[path]
    assert src.count(old) == 1
    found = ta.analyze_source(src.replace(old, new), path, rules, cfg)
    assert [f.code for f in found] == ["DT402"]


def test_table_driven_binding_is_folded_for_every_row():
    """``_kernel`` binds its four faces through the ``_ENTRY`` table: one
    short count fails every row."""
    path = BINDINGS[0]
    src = (ROOT / path).read_text(encoding="utf-8")
    old = "[ctypes.c_int] * n_int\n"
    assert src.count(old) == 1
    found = ta.analyze_source(
        src.replace(old, "[ctypes.c_int] * (n_int - 1)\n"), path,
        ta.rules_for(["DT402"]), ta.AnalysisConfig(root=ROOT))
    assert len(found) == 4 and len({f.line for f in found}) == 1
