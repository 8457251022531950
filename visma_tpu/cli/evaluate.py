"""Quantitative evaluation from a tool.json config
(reference parity: example/example_evaluate.cpp + cfg/tool.json)."""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="tool.json (reference cfg/tool.json keys)")
    args = ap.parse_args(argv)

    from visma_tpu.eval import quantitative_evaluation
    from visma_tpu.io import load_json
    from visma_tpu.utils import TermColor

    cfg = load_json(args.config)
    metrics = quantitative_evaluation(cfg)
    for name, m in metrics.items():
        print(TermColor.wrap(f"{name} errors:", TermColor.cyan))
        for k in ("median", "mean", "std", "max", "min"):
            print(f"  {k}={m[k]:.6f}")
    print(json.dumps(metrics))


if __name__ == "__main__":
    main()
