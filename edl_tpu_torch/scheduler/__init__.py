"""The port's share of ``edl_tpu/scheduler``: the scale gates the
serving fleet damps its replica scaling with."""
