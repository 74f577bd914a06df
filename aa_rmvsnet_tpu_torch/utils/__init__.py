"""Run configuration presets and the memory estimate, device handling,
metrics, point-cloud quality, training logs and seeded synthetic inputs."""
