from .model import Model
from .sindy import SINDy
from .mlp import MLP
