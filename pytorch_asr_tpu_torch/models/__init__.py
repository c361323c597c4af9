"""CTC models: conv + BiLSTM (configs 1 and 2) and TCN (config 3)."""
