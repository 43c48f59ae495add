from .fanout import (
    DirectTranscriptionFanout,
    JointMLPQuadCostFanout,
    JointSINDyQuadCostFanout,
    MPPIFanout,
    QuadCostFanout,
)
from .mesh import pad_to_multiple
