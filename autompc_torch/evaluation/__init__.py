from .evaluator import HoldoutModelEvaluator, ModelEvaluator
from .model_metrics import get_model_rmse, get_model_rmse_batch, get_model_rmsmens
