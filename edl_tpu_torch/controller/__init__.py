"""The controller (the port of ``edl_tpu/controller``)."""
