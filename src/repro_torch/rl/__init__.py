"""RL algorithms of the port (TD3, SAC, DQN, PPO) and the algorithm
registry."""
from repro_torch.rl.registry import ALGOS, get_algo, make_agent  # noqa: F401
