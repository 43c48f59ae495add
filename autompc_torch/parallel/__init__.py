from .fanout import QuadCostFanout
from .mesh import pad_to_multiple
