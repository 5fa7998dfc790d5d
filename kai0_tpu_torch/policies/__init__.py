"""Policy runtime around ``pi0.sample_actions``."""
