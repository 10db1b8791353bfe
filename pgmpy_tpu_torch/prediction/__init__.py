from pgmpy_tpu_torch.prediction.naive_adjustment import NaiveAdjustmentRegressor

__all__ = ["NaiveAdjustmentRegressor"]
