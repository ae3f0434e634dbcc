"""Read a cell's control: the plain reference computed in bfloat16, put in
the program's place and held to the reference by the numbers `correct` is
decided on. Every limit has to sit below what the control reads.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line per seed: {"seed", "values": {name: value},
"limits": {name: limit}, "fails": [names over their limit]}.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from portbench import run as R


def control_values(files: dict, seed: int, device) -> dict:
    """{name: value} of the cell's control for one seed."""
    kind = importlib.import_module(f"portbench.kinds.{files['traffic']['kind']}")
    return kind.control(files["config"], files["traffic"], seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    files = R.cell_files(args.workload)
    for seed in args.seeds:
        values = control_values(files, seed, args.device)
        limits = files["limits"]
        fails = [k for k, v in values.items() if v > limits[k]]
        print(json.dumps({"seed": seed, "values": values, "limits": limits, "fails": fails}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
