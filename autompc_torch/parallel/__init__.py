from .fanout import (
    DirectTranscriptionFanout,
    JointKoopmanLassoQuadCostFanout,
    JointMLPQuadCostFanout,
    JointSINDyQuadCostFanout,
    MPPIFanout,
    QuadCostFanout,
)
from .mesh import pad_to_multiple
