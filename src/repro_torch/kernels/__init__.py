"""Hand-written Hopper kernels of the TGN training, RWKV6 and StarCoder2
serving paths and of the ``ops.gru`` cell, their plain PyTorch versions,
and the device dispatch.

    kernel             replaces (repro/kernels/...)       wrapper
    neighbor_sample    neighbor_sample.py:_sample_kernel  neighbor_sample.py
    fused_flush        fused_flush.py:_flush_kernel       fused_flush.py
    temporal_attn      temporal_attn.py:_attn_kernel      temporal_attn.py
    temporal_attn_bwd  temporal_attn.py:_attn_bwd_kernel  temporal_attn.py
    rwkv6              rwkv6_scan.py:_wkv_kernel          rwkv6_scan.py
    fused_gru          fused_gru.py:_gru_kernel           fused_gru.py
    fused_gru_bwd      fused_gru.py:_gru_bwd_kernel       fused_gru.py
    flash_attention    flash_attention.py:_fa_kernel      flash_attention.py

CUDA sources live in ``csrc/`` and are built by ``build.py`` at first use;
``ops.py`` is the entry point the model calls; ``ref.py`` holds the plain
versions.
"""
