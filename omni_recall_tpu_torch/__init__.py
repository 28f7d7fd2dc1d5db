"""PyTorch + CUDA port of omni_recall_tpu for NVIDIA Hopper (H100).

Certified-exact hybrid recall over an int8 device index, with the scan,
keyword and double-float cosine kernels written by hand in CUDA
(``csrc/``). The JAX package ``omni_recall_tpu`` stays the reference; this
package imports nothing from it.
"""

from omni_recall_tpu_torch.stopwords import STOP_WORDS  # noqa: F401
