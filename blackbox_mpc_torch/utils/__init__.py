from blackbox_mpc_torch.utils.metrics import LatencyTimer, MetricsWriter

__all__ = ["LatencyTimer", "MetricsWriter"]
