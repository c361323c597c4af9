"""Greedy CTC decoding and WER."""
