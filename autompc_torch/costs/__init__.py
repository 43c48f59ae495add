from .cost import Cost
from .quad_cost import QuadCost
from .thresh_cost import ThresholdCost
