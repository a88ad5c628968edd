"""The deployment layer: what turns the planner's replica targets into
running port processes, on one host or in a Kubernetes cluster.

- :mod:`.scale_watcher` (``python -m dynamo_tpu_torch.deploy.scale_watcher``)
  realises the ``VirtualConnector`` target ``planner/{ns}/target/{component}``
  as local copies of a worker command;
- :mod:`.controller` (``python -m dynamo_tpu_torch.deploy.controller``)
  realises a ``TpuGraphDeployment`` custom resource's service replica counts
  as Kubernetes Deployments that run ``dynamo_tpu_torch.worker``;
- ``recipes/`` holds launch scripts for one host (aggregated, disaggregated,
  KV-routed replicas) and for a multi-host 70B worker, ``k8s/`` the CRD and
  the manifests (GPU node pools), ``docker/`` the serving image.

Copies of the JAX package's ``deploy/scripts/scale_watcher.py`` and
``deploy/operator/controller.py`` on the port's store client and its own
HTTP/1.1 client. Neither module imports ``torch``: they run beside the
workers, as the store and the frontend do, and never touch the card.
"""
