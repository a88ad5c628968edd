"""The comparison that decides ``correct``, at a tiny size on the CPU: the
plain reference agrees with the port, a lower precision fails it, and so
does each fault a served cell can have, planted in the timed path."""

from __future__ import annotations

import json

import pytest
import torch

from dynamo_tpu_torch.engine import model as model_lib
from portbench import spec, weights
from portbench.reference import model as ref
from portbench.tests.conftest import CONFIGS, ROOT
from portbench.tests.test_portbench_harness import run_cell


@pytest.mark.parametrize(
    "name", sorted(CONFIGS),
    ids=lambda n: {"tiny": "dense", "tiny-moe": "moe"}.get(n, n))
def test_reference_logits_agree_with_the_port(name):
    """For every configuration of the tiny benchmark, whatever its
    architecture: the port's forward through its paged cache (the kernels'
    plain versions) and the architecture's reference block over the whole
    sequence, on the same weights: float32 logits agree to 1e-4."""
    from portbench.run import engine_config
    from dynamo_tpu_torch.engine import EngineConfig, ModelConfig

    cfg = CONFIGS[name]
    arch = spec.arch(ROOT / "portbench", cfg)
    shapes = arch.shapes(cfg)
    params = weights.make_params(arch.leaf_shapes(shapes), 17, "float32",
                                 "cpu")
    mcfg = arch.model_config(cfg, ModelConfig)
    ecfg = engine_config(cfg, EngineConfig)
    T = 40
    ids = torch.randint(1, shapes.vocab, (T,),
                        generator=torch.Generator().manual_seed(3))
    cache = model_lib.init_cache(mcfg, ecfg, torch.device("cpu"))
    tables = torch.arange(1, 5, dtype=torch.int32)[None]
    _, h = model_lib.forward(mcfg, ecfg, params, cache, ids[None],
                             torch.arange(T)[None], tables)
    port = model_lib.logits_fn(mcfg, params, h)[0]
    want = ref.logits(spec.reference(ROOT / "portbench", cfg), params, cfg,
                      ids)
    assert port.shape == want.shape == (T, shapes.vocab)
    assert (port - want).abs().max().item() < 1e-4


def logged_gaps(err, what):
    line = [ln for ln in err.splitlines() if what in ln][-1]
    return json.loads(line.split("gaps ", 1)[1].replace("'", '"'))


def test_served_tokens_read_no_gap(checkout, capsys):
    """Greedy tokens the port served in float32 are the reference's best
    at every position checked."""
    _, line, err = run_cell(checkout, "tiny-moe.closed", capsys)
    assert line["checks"]["mean_logit_gap"]["value"] < 1e-5
    assert logged_gaps(err, "served-token gaps")["max"] < 1e-4
    assert line["correct"] is True


@pytest.mark.parametrize("name,number", [
    ("tiny.open", "max_logit_gap"), ("tiny-moe.closed", "mean_logit_gap")])
def test_lower_precision_fails(checkout, capsys, name, number):
    """The control: the reference with float8 weights, judged in the
    program's place by the cell's own limit, is not correct; the program's
    own tokens, logged beside it, still read no gap."""
    _, line, err = run_cell(checkout, name, capsys, "--control")
    assert line["correct"] is False
    limit = line["checks"][number]["limit"]
    assert line["checks"][number]["value"] > 10 * limit
    assert logged_gaps(err, "control")[number.split("_")[0]] \
        == line["checks"][number]["value"]
    assert logged_gaps(err, "served-token gaps")["max"] < 1e-4


def _altered_token(monkeypatch):
    orig = model_lib.sample

    def sample(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(model_lib, "sample", sample)


def _state_unchanged(monkeypatch):
    # every K/V scatter lands in a copy: the cache keeps its old state
    monkeypatch.setattr(model_lib, "_bits", lambda t: t.clone())


def _half_the_batch(monkeypatch):
    orig = model_lib.forward

    def forward(cfg, eng, params, cache, tokens, *a, **k):
        cache, h = orig(cfg, eng, params, cache, tokens, *a, **k)
        if tokens.shape[1] == 1:          # a decode step: odd rows left out
            h = h.clone()
            h[1::2] = 0
        return cache, h
    monkeypatch.setattr(model_lib, "forward", forward)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_the_batch])
@pytest.mark.parametrize("name", ["tiny.open", "tiny-moe.closed"])
def test_each_fault_is_not_correct(checkout, capsys, monkeypatch, fault,
                                   name):
    fault(monkeypatch)
    _, line, _ = run_cell(checkout, name, capsys)
    assert line["correct"] is False
