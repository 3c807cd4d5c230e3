from ray_tpu_torch.job.sdk import JobStatus, JobSubmissionClient

__all__ = ["JobSubmissionClient", "JobStatus"]
