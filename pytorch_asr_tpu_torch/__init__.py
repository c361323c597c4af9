"""PyTorch + CUDA port of ``pytorch_asr_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this port is checked against; the
port imports neither JAX nor anything of that package.  Ported so far: the
greedy-CTC serving path and the training of ``ctc_bilstm_dev1h``, and the
serving path of ``ctc_bilstm_beam_lm`` (CTC prefix beam search with dense
n-gram shallow fusion), through ``python -m pytorch_asr_tpu_torch.decode``
and ``.train``, with hand-written CUDA kernels in ``csrc/``: the STFT
log-mel frontend, the LSTM sequence (inference, and training forward and
backward), the CTC alpha and beta recursions, and the whole prefix beam
search of an utterance.
"""
