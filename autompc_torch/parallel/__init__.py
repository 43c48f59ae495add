from .fanout import JointMLPQuadCostFanout, QuadCostFanout
from .mesh import pad_to_multiple
