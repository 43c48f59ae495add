from .fanout import (
    DirectTranscriptionFanout,
    JointGPQuadCostFanout,
    JointKoopmanLassoQuadCostFanout,
    JointMLPQuadCostFanout,
    JointSINDyQuadCostFanout,
    MPPIFanout,
    QuadCostFanout,
)
from .mesh import pad_to_multiple
