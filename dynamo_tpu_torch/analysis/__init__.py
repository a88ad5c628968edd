"""dynalint for the port — project-specific static analysis of the PyTorch,
CUDA and async hot paths (port of ``dynamo_tpu.analysis``).

CPU tests cannot see the failure modes that hurt a serving loop on the
card: hidden host syncs in the decode loop, state frozen into a CUDA graph
at capture, swallowed ``CancelledError``s, ``ctypes`` bindings that
disagree with the kernel's C signature, and ad-hoc mesh axis names, meshes
and process groups that fight the canonical layout. Each rule has the code
of the JAX rule it twins:

- ``DT1xx`` host-sync in hot paths (``.item()``, ``.cpu()``,
  ``torch.cuda.synchronize`` inside ``@hot_path`` functions / hot modules;
  a persistent buffer rebound to an out-of-place result)
- ``DT2xx`` capture hazards (mutable globals and Python branches on tensor
  arguments in a captured function, graphs built inside loops)
- ``DT3xx`` async discipline (blocking calls in coroutines, dropped task
  handles, ``CancelledError``-swallowing handlers)
- ``DT4xx`` kernel binding contracts (``argtypes`` kinds and counts, and
  call arities, against the ``extern "C"`` signatures in ``csrc/``)
- ``DT5xx`` sharding consistency (axis names / meshes / process groups
  outside ``dynamo_tpu_torch/parallel/layout.py`` and ``comm.py``)

Run ``python -m dynamo_tpu_torch.analysis --check``. Suppress a finding
inline with ``# dynalint: disable=DT102`` (same line, or
``disable-next-line=`` on the line above); grandfathered findings live in
``dynalint-baseline.json`` beside this module, regenerated with
``--update-baseline``.
"""

from .core import (  # noqa: F401
    AnalysisConfig,
    Finding,
    ModuleContext,
    Rule,
    analyze_source,
    iter_python_files,
    run_paths,
)
from .baseline import Baseline, fingerprint  # noqa: F401
from .rules import ALL_RULES, rules_for  # noqa: F401
