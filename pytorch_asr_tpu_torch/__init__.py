"""PyTorch + CUDA port of ``pytorch_asr_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference this port is checked against; the
port imports neither JAX nor anything of that package.  Ported so far: the
greedy-CTC serving path and the training of ``ctc_bilstm_dev1h``, the
serving path of ``ctc_bilstm_beam_lm`` (CTC prefix beam search with dense
n-gram or char RNN-LM shallow fusion, and the RNN LM's trainer), and the
serving and training of ``tcn_ctc_devclean`` (the TCN encoder), and of
``las_attention`` and ``joint_ctc_attention_960h`` (the LAS decoder, the
attention and joint CTC/attention beam searches, the CE and joint losses and
waveform augmentation, all in plain torch), through
``python -m pytorch_asr_tpu_torch.decode``, ``.train`` and ``.train_lm``,
with hand-written CUDA kernels in ``csrc/``: the STFT log-mel frontend, the
LSTM sequence (inference, and training forward and backward), the CTC alpha
and beta recursions, the whole prefix beam search of an utterance (with the
RNN LM advanced inside it), and the fused TCN block (inference, and training
forward and backward).  Also ported, with the entry points that reach them in
the JAX package: its measured design studies, a BiLSTM layer's two directions
in one launch (``ops.lstm_cuda.bilstm_seq``), the CTC alpha two frames an
iteration (``ops.ctc_cuda.PAIRED_FWD``), and two more designs of the beam
search (``ops.beam_cuda.prefix_beam_fused``, ``prefix_beam_lanes_stepwise``)
with the benchmark scripts that run them (``scripts/``).
"""
