"""Evaluation: the metrics stream (``stream.py``) and the policy
leaderboard over the scenario × backend × codec grid
(``leaderboard.py``). Port of ``repro.eval``."""
