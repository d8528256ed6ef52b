"""CLI flag surface + yaml config round trip (the port's own copy of
gava_clip_tpu/utils/config.py, plus `--device`).

The flag names are the reference's public API (used by its shell scripts and
reloaded as the source of truth by the evaluation programs): the data
loader's flags, the checkpoint flags and the training flags. PyYAML is
imported where a config file is written or read.
"""

import argparse
import os.path as osp
from typing import List, Optional


def setup_data_args(parser: argparse.ArgumentParser):
    parser.add_argument('--train_list_path', type=str, default='')
    parser.add_argument('--val_list_path', type=str, default='')
    parser.add_argument('--train_data_root', type=str, default='')
    parser.add_argument('--val_data_root', type=str, default='')
    parser.add_argument('--eval_list_path', type=str, default='')
    parser.add_argument('--eval_data_root', type=str, default='')
    parser.add_argument('--data_root', type=str, default='')
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--num_spatial_views', type=int, default=1)
    parser.add_argument('--num_temporal_views', type=int, default=10)
    parser.add_argument('--num_frames', type=int, default=8)
    parser.add_argument('--sampling_rate', type=int, default=1)
    parser.add_argument('--tsn_sampling', action='store_true')
    parser.add_argument('--spatial_size', type=int, default=224)
    parser.add_argument('--mean', type=float, nargs='+')
    parser.add_argument('--std', type=float, nargs='+')
    parser.add_argument('--num_workers', type=int, default=10)
    parser.add_argument('--decoded_cache_dir', type=str, default='',
                        help='cache deterministic decoded uint8 views as '
                             'npy under this dir; rereads skip cv2 decode')
    parser.add_argument('--device_prefetch', type=int, default=2,
                        help='host-to-device read-ahead depth: copy batch '
                             'N+1 on a side CUDA stream from pinned memory '
                             'while the device runs step N (0 disables)')
    parser.add_argument('--dummy_dataset', action='store_true')
    parser.add_argument('--auto_augment', type=str)
    parser.add_argument('--interpolation', type=str, default='bicubic')
    parser.add_argument('--no_mirror', action='store_false', dest='mirror')
    parser.set_defaults(mirror=True)
    parser.add_argument('--no_seek_decode', action='store_false',
                        dest='allow_seek',
                        help='decode sequentially instead of seeking '
                             '(reference parity on VFR/broken-timestamp '
                             'containers where POS_FRAMES seeks are '
                             'frame-inaccurate)')
    parser.set_defaults(allow_seek=True)


def setup_checkpoint_args(parser: argparse.ArgumentParser):
    parser.add_argument('--checkpoint_dir', type=str)
    parser.add_argument('--auto_resume', action='store_true')
    parser.add_argument('--resume_path', type=str)
    parser.add_argument('--pretrain', type=str)


def setup_train_args(parser: argparse.ArgumentParser):
    parser.add_argument('--nfold', type=int, default=1)
    parser.add_argument('--type', choices=['updrs', 'updrs_3cls', 'diag', 'diag_3cls'],
                        default='diag')
    parser.add_argument('--num_steps', type=int)
    parser.add_argument('--eval_only', action='store_true')
    parser.add_argument('--save_freq', type=int, default=5000)
    parser.add_argument('--eval_freq', type=int, default=5000)
    parser.add_argument('--print_freq', type=int, default=10)
    parser.add_argument('--lr', type=float, default=4e-4)
    parser.add_argument('--weight_decay', type=float, default=0.2)
    parser.add_argument('--batch_split', type=int, default=1)
    parser.add_argument('--for_zero_shot', action='store_true')
    parser.add_argument('--early_stop_steps', type=int, default=10000)
    parser.add_argument('--backbone_path', type=str, default='')
    parser.add_argument('--checkpoint_path', type=str, default='')
    # model params
    parser.add_argument('--patch_size', type=int, default=16)
    parser.add_argument('--num_heads', type=int, default=12)
    parser.add_argument('--num_layers', type=int, default=12)
    parser.add_argument('--feature_dim', type=int, default=768)
    parser.add_argument('--embed_dim', type=int, default=512)
    parser.add_argument('--mlp_factor', type=float, default=4.0)
    parser.add_argument('--cls_dropout', type=float, default=0.5)
    # zeroshot
    parser.add_argument('--zeroshot_evaluation', action='store_true')
    parser.add_argument('--zeroshot_text_features_path', type=str,
                        default='./ucf101_text_features_B16/class-only.pth')
    # precision (reference: fp16 autocast; here: bf16)
    parser.add_argument('--use_fp16', action='store_true', dest='fp16')
    parser.set_defaults(fp16=False)
    parser.add_argument('--use_bf16', action='store_true', dest='bf16',
                        help='bf16 compute (replaces fp16 + GradScaler)')
    parser.set_defaults(bf16=False)
    # vision prompts
    parser.add_argument('--use_summary_token', action='store_true')
    parser.add_argument('--use_local_prompts', action='store_true')
    parser.add_argument('--use_global_prompts', action='store_true')
    parser.add_argument('--num_global_prompts', type=int, default=8)
    # text prompts
    parser.add_argument('--use_text_prompt_learning', action='store_true')
    parser.add_argument('--text_context_length', type=int, default=77)
    parser.add_argument('--text_vocab_size', type=int, default=49408)
    parser.add_argument('--text_transformer_width', type=int, default=512)
    parser.add_argument('--text_transformer_heads', type=int, default=8)
    parser.add_argument('--text_transformer_layers', type=int, default=12)
    parser.add_argument('--text_num_prompts', type=int, default=16)
    parser.add_argument('--text_prompt_pos', type=str, default='end')
    parser.add_argument('--text_prompt_init', type=str, default='')
    parser.add_argument('--use_text_prompt_CSC', action='store_true',
                        dest='text_prompt_CSC')
    parser.add_argument('--text_prompt_classes_path', type=str,
                        default='./classes/k400_classes.txt')
    parser.add_argument('--knowledge_version', action='append', type=str, default=[])
    parser.add_argument('--use_descriptor', action='store_true')
    parser.add_argument('--token_wise_mlp', action='store_true')
    parser.add_argument('--knowledge_dir', type=str, default='',
                        help='override ./data/ke_<type> knowledge directory')
    # losses
    parser.add_argument('--use_focal_ordinal_loss', action='store_true',
                        dest='focal_ordinal_loss')
    parser.add_argument('--use_sigmoid_loss', action='store_true',
                        dest='sigmoid_loss')
    # support memory / NTE
    parser.add_argument('--clLoss_nte_video', dest='add_nte', action='store_true')
    parser.add_argument('--use_support_memory', action='store_true')
    parser.add_argument('--memory_data_path', type=str,
                        default='./data/gait/data_dict_part4.pkl')
    parser.add_argument('--mem_batch_size', type=int, default=64)
    parser.add_argument('--class_wise_mlp', action='store_true')
    parser.add_argument('--memory_loss_weight', type=float, default=0.1)
    parser.add_argument('--vnte_loss_weight', type=float, default=0.05)
    parser.add_argument('--detach', action='store_true')
    parser.add_argument('--eval_all_views', action='store_true',
                        help='average logits over all spatial x temporal eval '
                             'views (beyond parity: the reference keeps view 0)')
    parser.add_argument('--quantize_eval', choices=['', 'w8', 'w8a8'],
                        default='',
                        help='inference-only int8 for the evaluate/zero_shot '
                             'programs: w8 = weight-only int8 GEMMs, '
                             'w8a8 = int8 weights and per-row int8 '
                             'activations')
    # default 'save_attn_qkv' (the named selective policy): keep the
    # attention outputs and the q / k / v projections, so that the backward
    # re-runs neither the attention forward kernel nor LN1 + qkv
    parser.add_argument('--remat_policy', type=str, default='save_attn_qkv',
                        choices=['none', 'full', 'dots', 'save_attn', 'save_attn_qkv',
                                 'save_attn_mlp'],
                        help='vision-tower rematerialization for long clips: '
                             'full = recompute whole blocks in backward '
                             '(lowest memory), dots = save GEMM outputs, '
                             'recompute attention einsums only, save_attn = '
                             'full but keep the flash-attention outputs '
                             '(skips the kernel re-run in backward), '
                             'save_attn_qkv = also keep q/k/v projections '
                             '(no recompute upstream of the flash backward), '
                             'save_attn_mlp = also keep the pre-activation '
                             'MLP hiddens')
    # observability (the reference has print-only timing)
    parser.add_argument('--profile_dir', type=str, default='',
                        help='write a torch.profiler trace of a few train '
                             'steps here')
    parser.add_argument('--nan_recovery', action='store_true',
                        help='on a non-finite loss, roll back to the last '
                             'checkpoint and continue (failure detection; '
                             'the reference has none)')
    parser.add_argument('--int8_frozen', action='store_true',
                        help='run the frozen CLIP backbone projections as '
                             'int8 GEMMs in the train forward (straight-'
                             'through bf16 backward for dx). Not ported '
                             'yet: raises (ROADMAP A9)')
    parser.add_argument('--debug_attn_clamp', action='store_true',
                        help='monitor the flash-attention exp2-clamp: '
                             'recompute the exact max scaled logit outside '
                             'the kernel and warn if a trained tower drifts '
                             'toward the saturation threshold (110)')
    parser.add_argument('--device', type=str, default=None,
                        help='torch device; the default is the CUDA card '
                             '(an error without one), "cpu" runs the plain '
                             'versions of the kernels on the host')


def build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    setup_data_args(parser)
    setup_checkpoint_args(parser)
    setup_train_args(parser)
    return parser


def save_config(args: argparse.Namespace, path: str):
    """Dump the namespace to config.yaml."""
    import yaml
    with open(path, 'w') as f:
        yaml.dump(vars(args), f)


def load_config_into(args: argparse.Namespace, path: str,
                     skip: Optional[List[str]] = None) -> argparse.Namespace:
    """Overlay a saved config.yaml back onto a namespace: the evaluation
    programs' source-of-truth reload."""
    import yaml
    skip = set(skip or [])
    with open(path) as f:
        saved = yaml.safe_load(f)
    for k, v in saved.items():
        if k not in skip:
            setattr(args, k, v)
    return args


def remap_fold_data_root(args: argparse.Namespace, fold: int):
    """Per-fold dataset root remapping of the reference training script."""
    if args.for_zero_shot:
        args.data_root = f'datasets/hospital/chunks_{fold}/'
    elif 'park' in args.data_root:
        args.data_root = 'datasets/parkinson_cv/'
    elif 'mix' in args.data_root:
        args.data_root = 'datasets/mix/'
    elif 'real' in args.data_root:
        args.data_root = 'datasets/real_3cls/train/'
    elif 'miccai' in args.data_root:
        args.data_root = f'datasets/miccai_10_fold/chunks_{fold}'
    elif 'tulip' in args.data_root:
        args.data_root = f'datasets/tulip/chunks_{fold}'
    args.train_list_path = osp.join(args.data_root, f'train_{args.type}.csv')
    args.val_list_path = osp.join(args.data_root, f'val_{args.type}.csv')
    if 'sep' in args.data_root:
        args.data_root = ''
        args.train_data_root = 'datasets/mix/'
        args.val_data_root = 'datasets/real_3cls/train/'
        args.train_list_path = osp.join(args.train_data_root, f'train_{args.type}_sep.csv')
        args.val_list_path = osp.join(args.val_data_root, f'val_{args.type}_sep.csv')
