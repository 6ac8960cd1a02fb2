"""The port's Gibbs engine: structures, updaters, sweep and sampler."""
