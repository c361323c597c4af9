"""PyTorch + CUDA port of ``pytorch_asr_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this port is checked against; the
port imports neither JAX nor anything of that package.  Ported so far: the
greedy-CTC serving path and the training of ``ctc_bilstm_dev1h``, the
serving path of ``ctc_bilstm_beam_lm`` (CTC prefix beam search with dense
n-gram shallow fusion), and the serving and training of ``tcn_ctc_devclean``
(the TCN encoder), through ``python -m pytorch_asr_tpu_torch.decode`` and
``.train``, with hand-written CUDA kernels in ``csrc/``: the STFT log-mel
frontend, the LSTM sequence (inference, and training forward and backward),
the CTC alpha and beta recursions, the whole prefix beam search of an
utterance, and the fused TCN block (inference, and training forward and
backward).
"""
