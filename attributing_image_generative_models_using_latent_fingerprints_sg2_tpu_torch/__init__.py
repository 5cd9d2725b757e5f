"""PyTorch + CUDA port of the latent-fingerprinting framework, for NVIDIA Hopper.

The JAX package ``attributing_image_generative_models_using_latent_fingerprints_sg2_tpu``
is the reference; this package mirrors its module layout (``ops/``,
``models/``, ``losses/``, ``fingerprint/``, ``utils/``, ``cli/``) so each
counterpart is found by path.  It imports ``torch`` and never ``jax``.

Conventions kept from the reference so the two can be compared directly:
NHWC activations and HWIO conv weights at every public function, parameter
trees as nested dicts/lists of tensors with the reference's names.  Every
function that draws randomness takes an explicit ``torch.Generator`` and
also accepts the drawn arrays, so a test can feed it the reference's draws.

The Pallas TPU kernels of the reference are hand-written CUDA kernels here
(``csrc/*.cu``, built on first use with ``nvcc`` for ``sm_90a``); on a CPU
tensor each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
