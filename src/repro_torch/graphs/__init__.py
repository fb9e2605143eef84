"""Graph applications from the paper's evaluation (§7-8), written against
the Masked SpGEMM primitive as a GraphBLAS user would."""
from .triangle_counting import degree_relabel, tc_flops, triangle_count

__all__ = ["degree_relabel", "tc_flops", "triangle_count"]
