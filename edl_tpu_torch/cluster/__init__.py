"""The cluster model (the port of ``edl_tpu/cluster``, without
``kube.py``)."""
