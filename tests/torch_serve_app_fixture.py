"""Importable serve apps for the port's declarative-deploy tests: the copy of
tests/serve_app_fixture.py on ray_tpu_torch.serve, addressed by
"tests.torch_serve_app_fixture:<attr>" import paths."""

from ray_tpu_torch import serve


@serve.deployment
class Adder:
    def __init__(self, offset: int = 0):
        self.offset = offset

    def __call__(self, payload):
        return {"sum": payload["a"] + payload["b"] + self.offset}


adder_app = Adder.bind()
adder_deployment = Adder  # bare Deployment: user_config feeds the ctor


def build_adder():
    """Zero-arg builder path."""
    return Adder.bind(offset=100)


@serve.deployment(stream=True)
class TokenStreamer:
    def __call__(self, prompt):
        for i, word in enumerate(str(prompt).split()):
            yield {"index": i, "token": word}
