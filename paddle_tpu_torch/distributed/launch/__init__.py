"""The launcher of the port (after ``paddle_tpu/distributed/launch/``;
upstream ``python/paddle/distributed/launch/``: ``main.py``'s command,
``controllers/``'s watcher and collective teardown, the elastic master).

``python -m paddle_tpu_torch.distributed.launch [--nproc_per_node N]
train.py`` starts one process a rank with the reference's environment
contract, kept as it is: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_CURRENT_ENDPOINT``,
``PADDLE_MASTER`` (and ``FLAGS_selected_gpus`` with ``--devices``).
"""
from .main import launch, launch_with_master, main  # noqa: F401
from .controllers import ElasticSupervisor, Watcher, build_env  # noqa: F401
from .master import ElasticMaster, NodeAgent  # noqa: F401
