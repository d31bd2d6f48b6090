"""Traffic mixes (``<mix>.json``) and the one generator that makes their inputs."""
