"""Repeat ``chip_smoke.py``'s phase 14 (``GET /debug/profile?ms=500`` over
phase 3's traffic) many times on one engine, to catch a capture that hangs.

Runs phases 1 (build), 3 (the bf16 engine and its graph check), 3's spec
check, 12 (autotune) and 13 (ladder) as ``chip_smoke.py`` runs them, so the
engine is in the state phase 14 finds it in, then N captures. A capture
that does not end within ``--limit`` seconds dumps every thread's stack to
stderr and exits non-zero (``faulthandler``). Needs one card::

    python3 scripts/profile_soak.py --captures 40
"""

import argparse
import faulthandler
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--captures", type=int, default=40)
    ap.add_argument("--limit", type=float, default=60.0,
                    help="seconds one capture may take before the stacks "
                         "are dumped and the script exits")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this soak needs a card")
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"[soak] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    cs.phase_build()
    _, engine, _, direct = cs.phase_engine(card)
    cs.phase_graph(engine, card)
    spec_engine, _ = cs.phase_spec(card, engine)
    cs.phase_spec_graph(spec_engine, card)
    del spec_engine
    torch.cuda.empty_cache()
    cs.phase_autotune(card, engine, direct)
    cs.phase_ladder(card)
    # phase 14's own watchdog bounds each capture; between captures it
    # re-arms the whole script's limit, which a long soak must not meet
    cs.PROFILE_WATCHDOG_S = args.limit
    cs.SCRIPT_LIMIT_S = 10 ** 6
    t0 = time.perf_counter()
    for i in range(args.captures):
        print(f"[soak] capture {i + 1} of {args.captures}", flush=True)
        cs.phase_debug_profile(card, engine)
    faulthandler.cancel_dump_traceback_later()
    print(f"[soak] {card}: {args.captures} captures of {cs.PROFILE_MS} ms "
          f"under phase 3's traffic in {time.perf_counter() - t0:.1f} s, "
          f"none hung", flush=True)


if __name__ == "__main__":
    main()
