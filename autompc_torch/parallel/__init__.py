from .fanout import JointMLPQuadCostFanout, JointSINDyQuadCostFanout, QuadCostFanout
from .mesh import pad_to_multiple
