#!/usr/bin/env python3
"""The benchmark of ``sfm_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU.  Set-up
loads (on a checkout's first run: builds) the program's libraries, makes
the CUDA context, renders the cell's scene from ``--seed`` on the card,
times the process's first reconstruction and runs the cell's warm-up
passes; the window then runs reconstructions back to back for
``--seconds``.  The plain reference (``sfmref``) then works out the same
reconstruction and a sample of the window's passes, drawn from the seed,
is judged against it.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the lines before it give the sample counts,
percentiles, the card and its power limit.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read from
stage spans over every pass and from a profiler session over a few passes
in the middle of the window.

Exits 1 without a result when there is no CUDA device (or fewer than the
cell asks for), when the program cannot be imported, or when jax, jaxlib,
flax or ``sfm_tpu`` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "benchmark_cache")


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else \
        f"unread (rc {proc.returncode})"


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # Every cache of the run lies at a fixed path inside the checkout.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from benchkit.catalog import Catalog
    from benchkit.harness import forbidden_modules, run_cell

    entry = Catalog(ROOT).cells.get(args.workload)
    if entry is None:
        print(f"error: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"error: the cell needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 1
    print(f"card: {power_limit()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      args.trace == 1, "cuda", T_START,
                      log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded in the benchmark's process: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
