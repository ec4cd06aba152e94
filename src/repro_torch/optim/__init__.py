"""AdamW for the training path."""
