"""DeepFM (the port of `repro.models.recsys`)."""
