"""The π₀.₅ full fine-tune step: optimizer, train state, train step."""
