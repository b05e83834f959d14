"""ocl_tpu_torch — the PyTorch / CUDA port of ocl_tpu, for one NVIDIA H100.

The JAX package ``ocl_tpu`` is the reference; every module here keeps its
counterpart's path, so ``ocl_tpu/buffer/aser.py`` is ported in
``ocl_tpu_torch/buffer/aser.py``. The port imports torch, numpy and scipy and
nothing of JAX or of ``ocl_tpu``.

Conventions:
  * images are NHWC float32 at every public function, as in the JAX package;
    the model permutes to NCHW (channels_last memory) inside;
  * the device is explicit: callers pass it down, nothing guesses it;
  * randomness comes from explicit ``torch.Generator``s, and strategies take
    their random draws (uniforms, Gumbel noise) as tensor arguments;
  * the one TPU kernel of the repo (``pairwise_sqdist``) is a hand-written
    CUDA kernel (``csrc/pairwise_sqdist.cu``); its plain torch version serves
    CPU tensors only.
"""

__version__ = "0.1.0"
