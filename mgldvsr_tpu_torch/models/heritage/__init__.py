"""BasicSR-heritage architectures (SR, video SR, SwinIR, StyleGAN2, face
restoration and the rest), counterparts of ``mgldvsr_tpu/models/heritage``."""
