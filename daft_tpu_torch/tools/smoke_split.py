"""One phase of ``chip_smoke.py`` split by helper, on one GPU.

    python3 -m daft_tpu_torch.tools.smoke_split PHASE NAME [NAME ...]

Runs ``chip_smoke.PHASE(card)`` (a phase that needs no earlier phase's state,
such as ``phase_relational``) and prints the phase's wall seconds, then the
seconds spent inside each NAME and its number of calls, largest first. A NAME
is a function of ``chip_smoke`` (``check_q01``) or ``module.function``
(``gc.collect``, ``daft_tpu_torch.tools.lineitem.q01_reference``), looked up
where the phase looks it up. The times are inclusive: a helper's time counts in
every named helper that calls it. Run it from the repo's root.

Exits non-zero with no CUDA device, or when the phase fails a check.
"""

from __future__ import annotations

import collections
import functools
import importlib
import sys
import time


def timed(owner, attr: str, label: str, totals: dict, calls: collections.Counter) -> None:
    """Replace ``owner.attr`` by a wrapper that adds its wall time to ``totals[label]``."""
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            totals[label] += time.perf_counter() - t0
            calls[label] += 1

    setattr(owner, attr, wrapper)


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("smoke_split: no CUDA device is visible", file=sys.stderr)
        return 2
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke

    totals, calls = collections.defaultdict(float), collections.Counter()
    for name in argv[1:]:
        module, _, attr = name.rpartition(".")
        owner = importlib.import_module(module) if module else chip_smoke
        timed(owner, attr, name, totals, calls)
    card = chip_smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    try:
        getattr(chip_smoke, argv[0])(card)
    except chip_smoke.SmokeFailure as e:
        print(f"smoke_split: {argv[0]} FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[split] {argv[0]} took {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    for name, s in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"[split]   {name}: {s:.2f} s over {calls[name]} call(s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
