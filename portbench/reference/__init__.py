"""The plain reference: StyleGAN2 synthesis, LPIPS-VGG16, the fingerprint
embedding and the solver's step, in plain PyTorch, float32 with TF32 off.

It imports neither JAX nor anything of the port, and takes nothing the port
has made: it draws the inputs both sides are given (weights, noise, latents)
and works out again what the port derives from them (the PCA, the basis,
the target features, each step's loss, gradient and Adam update).  Every
matrix product and convolution goes through :mod:`.precision`, so the same
code computed in a lower precision is the control that the comparison has to
fail.
"""
