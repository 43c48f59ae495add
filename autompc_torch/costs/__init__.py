from .cost import Cost
from .quad_cost import QuadCost
from .thresh_cost import ThresholdCost
from .cost_factory import CostFactory
from .quad_cost_factory import QuadCostFactory
