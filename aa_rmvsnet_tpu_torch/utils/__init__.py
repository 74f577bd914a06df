"""Run configuration presets, device handling, metrics, training logs and
seeded synthetic inputs."""
