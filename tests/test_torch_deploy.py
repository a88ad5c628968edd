"""The port's launch recipes, manifests and image
(``dynamo_tpu_torch/deploy/{recipes,k8s,docker}``) name only port modules,
with flags the port's parsers accept.

Each recipe runs with a stand-in ``python`` first on ``PATH`` that records
its arguments and exits: every ``python -m`` line must name a
``dynamo_tpu_torch`` module whose parser (and, for a worker, the check of
served paths) accepts the flags, and the recorded lines equal the JAX
recipe's (``deploy/recipes/``) with ``dynamo_tpu.`` read as
``dynamo_tpu_torch.``, under the same environment variables and defaults.
Every container of the manifests (parsed with ``yaml``; the disaggregated
overlay's patch applied) runs a port module its parser accepts, on GPU
node pools; the CRD declares the connector's group and version; the
Dockerfile names neither ``dynamo_tpu.`` nor JAX."""

import json
import os
import re
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from dynamo_tpu_torch import metrics_aggregator, worker
from dynamo_tpu_torch.deploy import controller as tctl
from dynamo_tpu_torch.frontend import __main__ as frontend_main
from dynamo_tpu_torch.planner import __main__ as planner_main
from dynamo_tpu_torch.planner import kubernetes_connector as tk
from dynamo_tpu_torch.runtime import store

ROOT = Path(__file__).resolve().parent.parent
PORT_DEPLOY = ROOT / "dynamo_tpu_torch" / "deploy"
RECIPES = ("agg-single-host", "disagg-single-host", "kv-routed-replicas",
           "llama70b-multihost")
# what each recipe requires from its caller (``${VAR:?...}``)
RECIPE_ENV = {"MODEL_DIR": "/models/llama", "HOST_INDEX": "0",
              "COORD": "10.0.0.1"}
MANIFESTS = sorted((PORT_DEPLOY / "k8s").rglob("*.yaml"))


def parse_flags(module: str, flags):
    """The port module's parser on ``flags``; a worker's flags also pass the
    worker's check of served paths."""
    parsers = {
        "dynamo_tpu_torch.runtime.store": store.parse_args,
        "dynamo_tpu_torch.worker": worker.parse_args,
        "dynamo_tpu_torch.frontend": frontend_main.parse_args,
        "dynamo_tpu_torch.planner": planner_main.parse_args,
        "dynamo_tpu_torch.metrics_aggregator": metrics_aggregator.parse_args,
    }
    assert module in parsers, f"not a port entry point: {module}"
    args = parsers[module](list(flags))
    if module == "dynamo_tpu_torch.worker":
        worker.check_supported(args)
    return args


def run_recipe(path: Path, tmp_path: Path, env_extra=None):
    """Run a recipe with a stand-in ``python`` that records its argv; the
    recorded argument lists, in the order they ran."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / f"calls-{len(list(tmp_path.glob('calls-*')))}.jsonl"
    stub = bin_dir / "python"
    stub.write_text(
        "#!/bin/sh\n"
        f"exec {sys.executable} -c 'import json, os, sys; "
        "open(os.environ[\"STUB_LOG\"], \"a\").write("
        "json.dumps(sys.argv[1:]) + \"\\n\")' \"$@\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               STUB_LOG=str(log))
    env.update(RECIPE_ENV, **(env_extra or {}))
    out = subprocess.run(["bash", str(path)], env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    return [json.loads(line) for line in log.read_text().splitlines()]


def recipe_env_defaults(path: Path) -> dict:
    """``VAR -> (":-" or ":?", default)`` for every ``VAR="${VAR:...}"``
    line of a recipe."""
    return {m.group(1): (m.group(2), m.group(3)) for m in re.finditer(
        r'^(\w+)="\$\{\1(:-|:\?)([^}]*)\}"', path.read_text(), re.M)}


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_runs_port_modules_with_accepted_flags(name, tmp_path):
    calls = run_recipe(PORT_DEPLOY / "recipes" / f"{name}.sh", tmp_path)
    assert calls
    for argv in calls:
        assert argv[0] == "-m", argv
        assert argv[1].startswith("dynamo_tpu_torch."), argv
        parse_flags(argv[1], argv[2:])


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_launches_what_the_jax_recipe_launches(name, tmp_path):
    port = PORT_DEPLOY / "recipes" / f"{name}.sh"
    jax = ROOT / "deploy" / "recipes" / f"{name}.sh"
    assert recipe_env_defaults(port) == recipe_env_defaults(jax)
    assert recipe_env_defaults(port)
    assert os.access(port, os.X_OK)

    def key(argv):
        return json.dumps(argv)

    got = sorted(map(key, run_recipe(port, tmp_path)))
    want = sorted(key([a.replace("dynamo_tpu.", "dynamo_tpu_torch.", 1)
                       if i == 1 else a for i, a in enumerate(argv)])
                  for argv in run_recipe(jax, tmp_path))
    assert got == want


def test_recipe_replica_counts_follow_the_environment(tmp_path):
    calls = run_recipe(PORT_DEPLOY / "recipes" / "kv-routed-replicas.sh",
                       tmp_path, {"REPLICAS": "3", "MESH": "1,1"})
    workers = [a for a in calls if a[1] == "dynamo_tpu_torch.worker"]
    assert len(workers) == 3
    assert all(a[a.index("--mesh") + 1] == "1,1" for a in workers)
    calls = run_recipe(PORT_DEPLOY / "recipes" / "llama70b-multihost.sh",
                       tmp_path, {"HOST_INDEX": "1", "NUM_HOSTS": "2"})
    # a follower host starts only its worker, on the whole world's mesh
    assert [a[1] for a in calls] == ["dynamo_tpu_torch.worker"]
    args = parse_flags(calls[0][1], calls[0][2:])
    assert (args.mesh, args.num_hosts, args.host_index, args.coordinator) \
        == ("1,8", 2, 1, "10.0.0.1:8476")


def containers(doc):
    spec = doc.get("spec", {}).get("template", {}).get("spec", {})
    return spec.get("containers", [])


def apply_json_patch(doc, ops):
    """The ``add .../args/-`` operations the disaggregated overlay uses."""
    for op in ops:
        assert op["op"] == "add" and op["path"].endswith("/args/-"), op
        parts = op["path"].strip("/").split("/")[:-1]
        node = doc
        for part in parts:
            node = node[int(part)] if part.isdigit() else node[part]
        node.append(op["value"])


def deployments():
    """Every Deployment of the manifests, the disaggregated overlay's
    patch applied to a copy of the base worker."""
    docs = [d for p in MANIFESTS for d in yaml.safe_load_all(p.read_text())
            if d]
    deps = {d["metadata"]["name"]: d for d in docs
            if d.get("kind") == "Deployment"}
    overlay = yaml.safe_load(
        (PORT_DEPLOY / "k8s/overlays/disagg/kustomization.yaml").read_text())
    for patch in overlay["patches"]:
        name = patch["target"]["name"]
        patched = json.loads(json.dumps(deps[name]))
        apply_json_patch(patched, yaml.safe_load(patch["patch"]))
        deps[f"{name} (disagg overlay)"] = patched
    return deps


def test_manifest_containers_run_port_modules_with_accepted_flags():
    deps = deployments()
    assert {"dynamo-store", "dynamo-frontend", "dynamo-worker",
            "dynamo-metrics", "dynamo-planner", "dynamo-prefill",
            "dynamo-worker (disagg overlay)"} <= set(deps)
    seen = set()
    for name, dep in deps.items():
        for c in containers(dep):
            args = c["args"]
            assert args[0].startswith("dynamo_tpu_torch."), (name, args)
            assert c["image"].startswith("dynamo-tpu-torch:"), name
            parse_flags(args[0], args[1:])
            seen.add(args[0])
    assert seen == {"dynamo_tpu_torch.runtime.store",
                    "dynamo_tpu_torch.frontend", "dynamo_tpu_torch.worker",
                    "dynamo_tpu_torch.metrics_aggregator",
                    "dynamo_tpu_torch.planner"}
    patched = containers(deps["dynamo-worker (disagg overlay)"])[0]["args"]
    assert patched[-2:] == ["--disagg-mode", "decode"]


def test_manifest_workers_ask_for_gpus_not_tpus():
    for name, dep in deployments().items():
        text = json.dumps(dep)
        assert "google.com/tpu" not in text and "gke-tpu" not in text, name
        runs_worker = [c for c in containers(dep)
                       if c["args"][0] == "dynamo_tpu_torch.worker"]
        for c in runs_worker:
            assert c["resources"]["limits"]["nvidia.com/gpu"] >= 1, name
            assert "gke-accelerator" in json.dumps(
                dep["spec"]["template"]["spec"]["nodeSelector"]), name
        if not runs_worker:
            assert "nvidia.com/gpu" not in text, name


def test_crd_declares_the_connector_group_and_version():
    crd, example = list(yaml.safe_load_all(
        (PORT_DEPLOY / "k8s" / "crd.yaml").read_text()))
    assert crd["spec"]["group"] == tk.GROUP
    assert [v["name"] for v in crd["spec"]["versions"]] == [tk.VERSION]
    assert crd["spec"]["names"]["plural"] == tk.PLURAL
    assert crd["metadata"]["name"] == f"{tk.PLURAL}.{tk.GROUP}"
    assert example["apiVersion"] == f"{tk.GROUP}/{tk.VERSION}"
    assert example["kind"] == crd["spec"]["names"]["kind"]
    # the JAX package's CRD is the same resource
    jax_crd = next(yaml.safe_load_all(
        (ROOT / "deploy" / "k8s" / "crd.yaml").read_text()))
    assert jax_crd["spec"] == crd["spec"]
    # the controller renders each example service as a port worker pod
    ctl = tctl.GraphController(api=None, image="dynamo-tpu-torch:test")
    for service, spec in example["spec"]["services"].items():
        dep = ctl._render_deployment("llama-disagg", service, spec)
        c = containers(dep)[0]
        assert c["command"] == ["python"] and c["args"][0] == "-m"
        parse_flags(c["args"][1], c["args"][2:])


def test_dockerfile_names_the_port_only():
    text = (PORT_DEPLOY / "docker" / "Dockerfile").read_text()
    assert "dynamo_tpu." not in text
    assert "jax" not in text.lower()
    assert "COPY dynamo_tpu_torch ./dynamo_tpu_torch" in text
    entry = re.search(r"^CMD \[\"([\w.]+)\"\]", text, re.M).group(1)
    assert entry == "dynamo_tpu_torch.frontend"
