"""The plain reference: a dense GQA decoder and AdamW in plain PyTorch.

fp32 with TF32 off, written from the published equations (pre-norm
RMSNorm, half-split RoPE, causal grouped-query attention, SwiGLU or
tanh-GELU FFN, untied head). It imports nothing of the program and takes
only the benchmark's own weights (drawn again from the seed) and the
tokens the program served.
"""
