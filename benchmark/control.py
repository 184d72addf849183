"""The two readings that each limit of ``check`` is set between, on the card.

    python3 benchmark/control.py --config anno20 --seeds 101 102 103

For each seed, at the configuration's own size, in one process: the
survey from the seed, one pass of the program on the card (after one
warm-up pass on the first seed), the answers of the configuration's plain
reference, and the control's: that reference's ``run(survey,
control=True)``, in the precision below the one the configuration states
(for ``plainref``: float32 with TF32 products, below float32 with TF32
off).  Prints one JSON line per seed on standard output: the reference's
numbers, held by :mod:`.check`, for the program against the reference
(the lower reading) and for the control against the reference (the upper
reading).  The benchmark's own runs do not run it.
"""

import argparse
import json
import math
import os
import sys
import time

if __package__ in (None, ""):
    HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.dirname(HERE)] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    __package__ = "benchmark"

import torch  # noqa: E402

from benchmark import check, harness, registry, slampass, synthetic  # noqa: E402


def numbers(config: dict, reference, side: dict, ref: dict) -> dict:
    values, _ = check.compare(reference.numbers([side], ref), config["check"])
    return {k: (v if math.isfinite(v) else str(v)) for k, (v, _) in values.items()}


def readings(config: dict, reference, seed: int, device, warm: bool) -> dict:
    survey = synthetic.make_survey(**config["survey"], seed=seed)
    out = {"seed": seed}
    pkg = harness.program()
    items, gt, pings = slampass.survey_items(survey)
    cfg = slampass.pipeline_config(pkg.config, config["pipeline"])
    one_pass = slampass.make_pass(pkg, items, gt, pings, cfg, device)
    if warm:
        one_pass()
    record = one_pass()
    prog = reference.outputs(record)
    out.update(program_wall_s=record.end - record.start, program_lc=record.result.n_lc_accepted,
               program_ate=[record.result.ate_dr, record.result.ate_est])
    del record, one_pass
    t0 = time.perf_counter()
    ref = reference.run(survey)
    out["reference_s"] = time.perf_counter() - t0
    out["program"] = numbers(config, reference, prog, ref)
    t0 = time.perf_counter()
    out["control"] = numbers(config, reference, reference.run(survey, control=True), ref)
    out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py runs on the card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    reg = registry.Registry(harness.SPEC)
    config = reg.config(args.config)
    reference = reg.reference(config)
    print(f"[card] {harness.card_line()}", file=sys.stderr, flush=True)
    for k, seed in enumerate(args.seeds):
        print(json.dumps(readings(config, reference, seed, device, warm=k == 0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
