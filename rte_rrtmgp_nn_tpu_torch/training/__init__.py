"""NN gas-optics training: data generation, the train step and the
radiation-in-the-loop evaluation (port of rte_rrtmgp_nn_tpu/training)."""
