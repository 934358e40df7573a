"""Exploratory-analysis session on the taxi-like workload with the PyTorch
port: iterative browsing with pair lists and Predicate trees, group-by
quotas, and visualization-ready debiased aggregates (paper §1, §5, App. A).

  PYTHONPATH=src python examples/torch_browse_and_estimate.py            # on the card
  PYTHONPATH=src python examples/torch_browse_and_estimate.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.engine import NeedleTailEngine
from repro_torch.core.groupby import groupby_any_k
from repro_torch.core.online_agg import AggregateQuery, run_online_aggregate
from repro_torch.core.predicates import And, Eq, In, Not
from repro_torch.data.block_store import build_block_store
from repro_torch.data.synthetic import make_real_like_table


def main(device: str = "cuda", num_records: int = 300_000):
    table = make_real_like_table("taxi", num_records=num_records, seed=0)
    store = build_block_store(table, records_per_block=512, device=device)
    engine = NeedleTailEngine(store, device=device)

    # analyst loop: start broad, then refine (ad-hoc predicates)
    for preds, label in [
        ([(1, 5)], "month=Jun"),
        ([(1, 5), (2, 3)], "month=Jun AND hour=slot3"),
        (And((Eq(1, 5), In(2, (3, 4)), Not(Eq(4, 0)))), "Jun AND hour in 3..4 AND pax!=1"),
    ]:
        r = engine.any_k(preds, k=200, algo="auto")
        fares = r.measures[:, 0] if r.num_records else np.asarray([0.0])
        print(f"{label:34s} -> {r.num_records:4d} rows via {r.algo:9s} "
              f"({len(r.blocks_fetched)} blocks, {r.modeled_io_s*1e3:.1f} ms IO); "
              f"sample fare mean {fares.mean():.2f}")

    # screenful per taxi type (group-by any-k, Appendix A)
    g = groupby_any_k(engine, [(1, 5)], group_attr=0, k=25, psi=8)
    print(f"\nper-type quota: counts={g.per_group_counts.tolist()} "
          f"from {len(g.blocks_fetched)} blocks ({g.modeled_io_s*1e3:.1f} ms IO)")

    # visualization query: AVG(fare) GROUP BY taxi_type, debiased (§5 + A.3)
    print("\nAVG(fare) by taxi_type (hybrid ratio estimates vs truth):")
    for ttype in range(3):
        preds = [(0, ttype), (1, 5)]
        est, _, _ = engine.aggregate(preds, measure=0, k=1500, alpha=0.2,
                                     estimator="ratio", seed=1)
        truth = table.measures[table.valid_mask(preds), 0].mean()
        print(f"  type={ttype}: {est.mean:7.2f} ± {est.ci_halfwidth():5.2f} "
              f"(truth {truth:7.2f}, n={est.num_samples})")

    # the same question online: stop once the 95% CI is within 1% of the mean
    q = AggregateQuery([(1, 5)], measure=0, k=1500, alpha=0.2, seed=1)
    res = run_online_aggregate(engine, q, error_slo=0.01 * abs(est.mean), chunk_blocks=8)
    print(f"\nonline AVG(fare) month=Jun: {res.estimate.mean:.2f} ± "
          f"{res.estimate.ci_halfwidth():.2f} after {res.rounds} rounds "
          f"({res.blocks_fetched} blocks, stopped: {res.reason})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
