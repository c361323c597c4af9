"""conv + BiLSTM CTC model."""
