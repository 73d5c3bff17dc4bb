"""moonshine_tpu_torch: the PyTorch/CUDA port of the JAX package ``moonshine_tpu``.

Runs Moonshine's offline and streaming transcription on an NVIDIA GPU
(Hopper, ``sm_90a``), with hand-written CUDA kernels where the JAX package
has Pallas kernels for the TPU.  It imports neither JAX nor the JAX
package.

    from moonshine_tpu_torch import Transcriber

    t = Transcriber("base", "en", tokenizer_path="tokenizer.bin").load()
"""

from .api import MicTranscriber, Transcriber

__all__ = ["MicTranscriber", "Transcriber"]
