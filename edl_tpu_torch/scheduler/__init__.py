"""The scheduler (the port of ``edl_tpu/scheduler``): the cluster
autoscaler, its native planner and the scale gates."""
