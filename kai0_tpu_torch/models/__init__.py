"""SigLIP, the two-expert Gemma stack and the π₀.₅ flow-matching model."""
