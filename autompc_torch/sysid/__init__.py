from .model import Model
from .model import ModelFactory
from .arx import ARX, ARXFactory
from .sindy import SINDy, SINDyFactory
from .koopman import Koopman, KoopmanFactory
from .dummy import DummyLinear, DummyNonlinear, FunctionModel, LinearizedModel
from .mlp import MLP, MLPFactory
