#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--passes 2] [--out FILE]

For each seed: the cell's scene, the program's first reconstruction and
``--passes`` more (the window's entry at the window's sizes), each judged
against the plain reference (``sfmref``) as a run judges them: the lower
readings.  For each control seed also the control, the reference itself
computed one step below each precision the program states (TF32 products
for float32, float8 e4m3 descriptors for bf16, bfloat16 BA for float32),
in the program's place and judged the same way: the upper readings.  One JSON line per seed and side on standard output and in
``--out``.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from benchkit import judge, program, scene
    from benchkit.catalog import Catalog
    from benchkit.harness import judge_passes, n_pairs, ransac_uniforms
    from sfmref import sparse_stage

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    _, job, config = Catalog(ROOT).cell(args.workload)
    sc, pipe = config["scene"], config["pipeline"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program.load_libraries(device)
    out = open(args.out, "a") if args.out else None
    limits = job.get("limits", {})

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        images, K, R, t = scene.render(sc, seed, device)
        calib = program.calibration(K, R, t)
        pconfig = program.pipeline_config(config, job, device, seed)
        walls = [program.run_pass(program.fresh_copy(images), calib, pconfig,
                                  job, device)
                 for _ in range(1 + args.passes)]
        outs = [w.pop("out") for w in walls[1:]]
        uniforms = ransac_uniforms(n_pairs(sc["frames"], job["pair_mode"]),
                                   pipe["ransac"]["num_hypotheses"], seed)
        t0 = time.perf_counter()
        ref_sfm = sparse_stage(images, K, R, t, pipe, job, uniforms, device)
        numbers = judge_passes(outs, images, (K, R, t), pipe, job, uniforms,
                               device, reference_sfm=ref_sfm)
        ref_s = time.perf_counter() - t0
        correct, _ = judge.verdict(numbers, limits)
        emit({"workload": args.workload, "seed": seed, "side": "program",
              "walls": [w["wall"] for w in walls], "reference_s": ref_s,
              "correct": correct, "numbers": numbers})
        del outs
        if seed in controls:
            ctl = sparse_stage(images, K, R, t, pipe, job, uniforms, device,
                               control=True)
            ctl.update(judge.reference_next(images, (K, R, t), ctl, pipe,
                                            job, device, control=True))
            numbers = judge_passes([ctl], images, (K, R, t), pipe, job,
                                   uniforms, device, reference_sfm=ref_sfm)
            correct, _ = judge.verdict(numbers, limits)
            emit({"workload": args.workload, "seed": seed, "side": "control",
                  "correct": correct, "numbers": numbers})
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
