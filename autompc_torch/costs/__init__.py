from .cost import Cost
from .quad_cost import QuadCost
from .thresh_cost import BoxThresholdCost, ThresholdCost
from .cost_factory import CostFactory
from .quad_cost_factory import QuadCostFactory
from .sum_cost import SumCost
from .gauss_reg_factory import GaussRegFactory
from .sum_cost_factory import SumCostFactory
