from .model import Model
from .sindy import SINDy
