"""PyTorch + CUDA port of ``pytorch_asr_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this port is checked against; the
port imports neither JAX nor anything of that package.  Ported so far: the
greedy-CTC serving path of ``ctc_bilstm_dev1h`` (``python -m
pytorch_asr_tpu_torch.decode``), with hand-written CUDA kernels for the STFT
log-mel frontend (``ops/stft_cuda.py``) and the LSTM sequence
(``ops/lstm_cuda.py``).
"""
