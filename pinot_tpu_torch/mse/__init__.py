"""Multi-stage engine (MSE): joins over StackedTables on one device.

Port of pinot_tpu/mse.  Reference parity: pinot-query-planner and
pinot-query-runtime.
"""
from pinot_tpu_torch.mse.engine import MultiStageEngine
from pinot_tpu_torch.mse.plan import JoinPlanError

__all__ = ["MultiStageEngine", "JoinPlanError"]
