"""Graph analytics with Masked SpGEMM: TC, k-truss, betweenness centrality
(the paper's three benchmarks end-to-end, on an R-MAT graph), on the
PyTorch/CUDA port.

    PYTHONPATH=src python examples_torch/graph_analytics.py     # the card
    PYTHONPATH=src python examples_torch/graph_analytics.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.formats import rmat
from repro_torch.graphs import betweenness_centrality, ktruss, triangle_count


def main(argv=None) -> dict:
    """Run the example; returns its deterministic results."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run on the CPU)")

    g = rmat(9, 8, seed=7)
    print(f"R-MAT scale 9: n={g.shape[0]}, edges={g.nnz // 2}")

    tri, secs = triangle_count(g, algorithm="msa", device=device)
    print(f"triangles: {tri}  (masked-spgemm {secs * 1e3:.0f} ms)")

    truss, secs, iters, flops = ktruss(g, k=5, algorithm="msa",
                                       device=device)
    print(f"5-truss: {truss.nnz // 2} edges after {iters} iterations "
          f"({flops / max(secs, 1e-9) / 1e9:.2f} GFLOPS)")

    srcs = np.random.default_rng(0).choice(g.shape[0], 16, replace=False)
    bc, secs, calls = betweenness_centrality(g, sources=srcs,
                                             algorithm="msa", device=device)
    top = np.argsort(-bc)[:5]
    print(f"betweenness (batch=16, {calls} masked-spgemm calls, "
          f"{secs * 1e3:.0f} ms): top vertices {top.tolist()}")
    return {"triangles": tri, "ktruss_edges": truss.nnz // 2,
            "ktruss_iterations": iters, "bc_top5": top.tolist(),
            "bc": [float(x) for x in bc]}


if __name__ == "__main__":
    main()
