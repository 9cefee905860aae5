"""Column and g-point splitting over devices and over the ranks of a
process group, and host -> device block streaming (rte_rrtmgp_nn_tpu/parallel)."""
