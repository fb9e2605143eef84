"""Graph applications from the paper's evaluation (§7-8), written against
the Masked SpGEMM primitive as a GraphBLAS user would: triangle counting,
k-truss and betweenness centrality."""
from .betweenness import bc_teps, betweenness_centrality
from .ktruss import ktruss
from .triangle_counting import degree_relabel, tc_flops, triangle_count

__all__ = ["bc_teps", "betweenness_centrality", "degree_relabel", "ktruss",
           "tc_flops", "triangle_count"]
