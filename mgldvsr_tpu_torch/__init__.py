"""PyTorch + CUDA port of the MGLD-VSR restore path.

Mirrors the layout of the JAX package ``mgldvsr_tpu`` module for module, so
each function's counterpart is easy to find. Modules keep the upstream torch
state-dict key names and NCHW layouts; public functions keep the JAX
package's NHWC layout for frames, latents and flows.

Importing this package imports ``torch`` only: no JAX, no flax, and no
kernel is built until a CUDA tensor first reaches a kernel wrapper.
"""
