"""The paper's technique on MoE routing: the routing is a sparse matrix;
sorted dispatch = reordering; capacity = the nnz-balanced schedule; LI
(paper §6.1) is reported per step.

The routing here is the workload source's (repro_torch.workloads): a
seeded random router over random tokens, lowered to its dispatch and
combine matrices. The LM's MoE layer (and its auxiliary loss) is not
ported yet.

    python -m repro_torch.examples.moe_reordering [--tokens 4096] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import resolve_device
from ..workloads import DynamicSparseProblem, run_stream
from ..workloads import sources


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--d", type=int, default=128, help="model width")
    ap.add_argument("--stream-tokens", type=int, default=1024,
                    help="tokens of each step of the pipeline stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.tokens, args.d)).astype(np.float32)
    out = {}
    for e, k in [(16, 2), (64, 8)]:
        w_router = rng.standard_normal((args.d, e)).astype(np.float32) \
            / np.sqrt(args.d)
        gates, experts = sources.moe_route_np(x, w_router, k)
        cap = sources.moe_capacity(args.tokens, k, e)
        _, _, meta = sources.routing_matrices(experts, gates, e, cap)
        print(f"E={e:3d} top-{k}: router LI={meta['li']:.2f} "
              f"(1.0 = perfectly balanced), "
              f"dropped={meta['drop_frac']:.3%} under capacity "
              f"(nnz-balanced) schedule")
        out[f"e{e}_k{k}"] = meta

    # The same routing through the Problem->Plan->Operator pipeline:
    # dispatch/combine become registry operators, and a value-only stream
    # (routing structure frozen, gates changing) plans once per role and
    # then rebuilds/reuses — the paper's amortization question answered on
    # workload-shaped sparsity.
    name = f"workload://moe-e16-k2-t{args.stream_tokens}-d64-n4"
    rec = run_stream(DynamicSparseProblem(name, scenario="static"), iters=2,
                     device=dev)
    print(f"pipeline (E=16 top-2, {rec['steps']}-step value-only stream): "
          f"plans={rec['plans']} replans={rec['replans']} "
          f"reuse rate={rec['reuse_rate']:.0%}, "
          f"plan-cost share={rec['plan_cost_share']:.0%}, "
          f"sorted-vs-onehot speedup={rec['speedup_vs_ref']:.2f}x, "
          f"dispatch bitwise-equal={rec['dispatch_bitwise_equal']}")
    assert rec["replans"] == 0 and rec["dispatch_bitwise_equal"]
    out["stream"] = rec
    return out


if __name__ == "__main__":
    main()
