"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources live in ``csrc/`` and are built at first use
(``kernels._build``)."""

#: the ``csrc/<name>.cu`` sources of every kernel of the port
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd",
                  "paged_attention", "fused_bn_act", "fused_lstm")
