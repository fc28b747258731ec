"""Strategy search (counterpart of flexflow_tpu/search/): the machine,
cost and event models, MCMC, the view DP, the Unity substitution search
and its rule corpus, measured costs, and the entry points FFModel.compile
calls (api.py).
"""
