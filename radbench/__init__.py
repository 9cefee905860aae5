"""The benchmark of rte_rrtmgp_nn_tpu_torch: see run.py."""
