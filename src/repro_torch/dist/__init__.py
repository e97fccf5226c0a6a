"""The stacked-grid topology, exchange strategy and fold codecs."""
