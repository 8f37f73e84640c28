"""The example scripts on the port (PyTorch counterparts of the repository's
``examples/``): ``evaluate`` (RD evaluation of a registry model over an
image directory), ``train_synthetic`` (bls2017 trained on 1/f textures at
several lambdas) and ``pod_compress`` (the sidecar coder sharded over every
card).  Each runs as ``python -m compression_tpu_torch.examples.<name>``,
on the card unless ``--device cpu`` is given."""
