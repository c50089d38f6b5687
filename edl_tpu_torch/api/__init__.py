"""The job API (the port of ``edl_tpu/api``)."""
