"""The grid topologies (stacked on one device, or a rank's block of a
`torch.distributed` process group: `topology`, `multihost`), the exchange
strategies and the fold codecs."""
