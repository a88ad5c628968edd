"""``--mesh D,N`` on the port's one-process launcher and SLA profiler, as
processes on the CPU (``--device cpu``): the process the user starts
leads, and it starts the follower ranks of its own command line, which
replay its step plans from a ``TCPStore`` queue
(``parallel/multihost.py`` ``StorePlanChannel``).

- ``run.py in=batch out=engine --mesh 1,2`` (and with ``--weights``, each
  rank loading only its shard) prints the token ids that ``--mesh 1,1``
  prints from the same weights; both ranks log their exit line, the
  follower's plans equal to the leader's.
- ``planner.profiler --mesh 1,2`` writes the reference keys with the
  ``--mesh 1,1`` run's points, ``meta.mesh == [1, 2]``, and figures per
  chip from two chips.
- A 3-number ``--mesh`` raises the ``ValueError`` of the JAX launchers'
  ``dp, tp = ...split(",")`` on the launcher, the profiler and the worker.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = [[int(x) for x in np.random.RandomState(s).randint(1, 500, n)]
           for s, n in ((20, 9), (21, 40), (22, 17), (23, 3))]
RUN_ARGS = ["--model", "tiny", "--device", "cpu", "--num-blocks", "64",
            "--block-size", "4", "--max-model-len", "256"]
PROFILE_ARGS = ["--model", "tiny", "--device", "cpu", "--num-blocks",
                "256", "--isls", "16,48", "--batches", "1,3", "--contexts",
                "16,40"]
EXIT = re.compile(r"run exiting: tp rank=(\d) world=(\d) backend=gloo .*"
                  r"plans=(\S+)")


def _env():
    # one torch thread per rank process (the followers inherit it)
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def _python(*args, timeout=120):
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout,
                         env=_env())
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def _run(tmp_path, *extra):
    batch = tmp_path / "b.jsonl"
    batch.write_text("".join(json.dumps({"token_ids": p, "max_tokens": 6})
                             + "\n" for p in PROMPTS))
    out = _python("dynamo_tpu_torch.run", f"in=batch:{batch}", "out=engine",
                  *RUN_ARGS, *extra)
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.strip()]
    return [r["token_ids"] for r in rows], out.stderr


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("one"))[0]


def _check_ranks(stderr):
    ranks = {int(r): plans for r, world, plans in EXIT.findall(stderr)}
    assert sorted(ranks) == [0, 1], stderr[-4000:]
    assert ranks[0] == ranks[1] and "pp:" in ranks[0]


def test_run_mesh_1x2_prints_the_one_rank_tokens(one_rank, tmp_path):
    tokens, stderr = _run(tmp_path, "--mesh", "1,2")
    assert tokens == one_rank and [len(t) for t in tokens] == [6] * 4
    assert "started local ranks [1]" in stderr
    _check_ranks(stderr)


def test_run_mesh_1x2_serves_its_shards_of_a_checkpoint(tmp_path):
    """Each rank loads only its shard (``load_hf_params_sharded``) of a
    checkpoint, and the tokens are those ``--mesh 1,1`` prints from the
    whole checkpoint (its ``config.json`` makes the model bf16)."""
    import torch

    from dynamo_tpu_torch.engine import model as tm
    from dynamo_tpu_torch.engine.config import ModelConfig
    from dynamo_tpu_torch.engine.weights import save_hf_params

    cfg = ModelConfig.tiny()
    ckpt = tmp_path / "ckpt"
    save_hf_params(ckpt, tm.init_params(
        torch.Generator().manual_seed(0), cfg), cfg, n_shards=2)
    tokens, stderr = _run(tmp_path, "--mesh", "1,2", "--weights", str(ckpt))
    assert tokens == _run(tmp_path, "--weights", str(ckpt))[0]
    assert len(re.findall(r"loaded \d+ tensors .* shard \d/2", stderr)) == 2
    _check_ranks(stderr)


def _profile(tmp_path, mesh):
    out_path = tmp_path / f"profile_{mesh.replace(',', 'x')}.json"
    _python("dynamo_tpu_torch.planner.profiler", *PROFILE_ARGS, "--mesh",
            mesh, "--out", str(out_path), timeout=180)
    return json.loads(out_path.read_text())


def test_profiler_mesh_1x2_writes_the_one_rank_keys(tmp_path):
    one, two = _profile(tmp_path, "1,1"), _profile(tmp_path, "1,2")
    assert set(two) == set(one)
    assert two["meta"] == dict(one["meta"], mesh=[1, 2])
    for key in ("prefill_isl", "decode_context_length"):
        assert two[key] == one[key]
    assert all(v > 0 for v in two["prefill_ttft_s"]
               + two["prefill_thpt_per_chip"] + two["decode_itl_s"]
               + two["decode_thpt_per_chip"])
    # two chips: tok/s per chip is the prefill's tok/s over 2
    for isl, ttft, per_chip in zip(two["prefill_isl"], two["prefill_ttft_s"],
                                   two["prefill_thpt_per_chip"]):
        assert per_chip == pytest.approx(isl / ttft / 2)


def _jax_unpack_error() -> str:
    """The JAX launcher's error for ``--mesh 1,2,2``."""
    from dynamo_tpu import run as jrun

    with pytest.raises(ValueError) as e:
        jrun.build_output(jrun.parse_args(
            ["in=text", "out=engine", "--mesh", "1,2,2"]))
    return str(e.value)


def test_three_number_mesh_raises_the_jax_value_error(tmp_path):
    from dynamo_tpu_torch import run, worker
    from dynamo_tpu_torch.planner import profiler

    msg = re.escape(_jax_unpack_error())
    batch = tmp_path / "b.jsonl"
    batch.write_text('{"token_ids": [1, 2], "max_tokens": 2}\n')
    with pytest.raises(ValueError, match=msg):
        run.main([f"in=batch:{batch}", "out=engine", "--model", "tiny",
                  "--device", "cpu", "--mesh", "1,2,2"])
    with pytest.raises(ValueError, match=msg):
        profiler.build_engine(profiler.parse_args(
            ["--device", "cpu", "--mesh", "1,2,2"]))
    with pytest.raises(ValueError, match=msg):
        worker.check_supported(worker.parse_args(
            ["--device", "cpu", "--mesh", "1,2,2"]))
