"""Deployment definitions and applications (own copy of
ray_tpu.serve.deployment).

Reference capability: python/ray/serve/deployment.py (@serve.deployment
decorator, Deployment.options / .bind) and serve/_private/deployment_state.py
(target state records). A Deployment is a declarative spec; binding it with
constructor args yields an Application that serve.run() materializes through
the controller.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class AutoscalingConfig:
    """Queue-depth autoscaling (reference: serve/config.py AutoscalingConfig +
    serve/_private/autoscaling_state.py:262 decision logic)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0
    metrics_interval_s: float = 0.5


@dataclass(frozen=True)
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 8
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    user_config: Optional[Dict[str, Any]] = None
    health_check_period_s: float = 2.0
    # stream=True: HTTP responses are sent chunked as the callable's
    # generator yields (reference: serve/_private/proxy.py:542 streaming
    # send_request_to_replica); python handles use .options(stream=True)
    stream: bool = False

    def options(self, **kwargs) -> "Deployment":
        if "autoscaling_config" in kwargs and isinstance(kwargs["autoscaling_config"], dict):
            kwargs["autoscaling_config"] = AutoscalingConfig(**kwargs["autoscaling_config"])
        return replace(self, **kwargs)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(deployment=self, init_args=args, init_kwargs=kwargs)

    @property
    def target_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return self.autoscaling_config.min_replicas
        return self.num_replicas


@dataclass(frozen=True)
class Application:
    deployment: Deployment
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = field(default_factory=dict)


def deployment(
    _func_or_class: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    num_replicas: int = 1,
    max_ongoing_requests: int = 8,
    ray_actor_options: Optional[Dict[str, Any]] = None,
    autoscaling_config: Optional[Any] = None,
    user_config: Optional[Dict[str, Any]] = None,
    stream: bool = False,
):
    """@serve.deployment decorator (reference: serve/api.py:deployment)."""

    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)

    def wrap(target):
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            stream=stream,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
