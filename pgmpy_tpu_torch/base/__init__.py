from pgmpy_tpu_torch.base.dag import DAG
from pgmpy_tpu_torch.base.pdag import PDAG
from pgmpy_tpu_torch.base.undirected import UndirectedGraph
from pgmpy_tpu_torch.base.roles import GraphRolesMixin
from pgmpy_tpu_torch.base.admg import ADMG
from pgmpy_tpu_torch.base.mag import MAG, AncestralBase

__all__ = ["DAG", "PDAG", "UndirectedGraph", "GraphRolesMixin", "ADMG", "MAG", "AncestralBase"]
