from .model import Model
from .model import ModelFactory
from .arx import ARX, ARXFactory
from .sindy import SINDy, SINDyFactory
from .koopman import Koopman, KoopmanFactory
from .dummy import DummyLinear, DummyNonlinear, FunctionModel, LinearizedModel
from .mlp import MLP, MLPFactory
from .gp import (
    ApproximateGPModel,
    ApproximateGPModelFactory,
    LargeGaussianProcess,
    gp_pred_core_cached,
    svgp_mean_weights,
    train_svgp_buckets,
)
