from blackbox_mpc_torch.utils.metrics import LatencyTimer, MetricsWriter
from blackbox_mpc_torch.utils.profiling import profile_policy_solve, trace

__all__ = ["LatencyTimer", "MetricsWriter", "profile_policy_solve", "trace"]
