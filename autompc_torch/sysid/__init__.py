from .model import Model
from .model import ModelFactory
from .sindy import SINDy, SINDyFactory
from .dummy import FunctionModel
from .mlp import MLP
