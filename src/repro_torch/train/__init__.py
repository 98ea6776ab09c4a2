"""Training: AdamW, the train step and the train loop."""
