"""Column splitting over devices and host -> device block streaming (the
single-process part of rte_rrtmgp_nn_tpu/parallel)."""
