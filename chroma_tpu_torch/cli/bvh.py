"""Create / inspect / manage BVHs (counterpart of chroma_tpu/cli/bvh.py;
parity: reference bin/chroma-bvh).  Builds run on the host (vectorized
numpy); no card needed."""
import argparse
import time


def parse_bvh_id(bvh_id):
    """'geo_name:bvh_name' -> (geo_name, bvh_name)."""
    if ':' in bvh_id:
        geo_name, bvh_name = bvh_id.split(':')
        if not bvh_name:
            bvh_name = 'default'
    else:
        geo_name, bvh_name = bvh_id, 'default'
    return geo_name, bvh_name


def print_stat(geo_name, bvh_name, mesh_hash, bvh):
    print('BVH %s:%s (mesh hash %s)' % (geo_name, bvh_name, mesh_hash))
    print('  nodes:  %d' % len(bvh))
    print('  layers: %d' % bvh.layer_count())
    for i in range(bvh.layer_count()):
        layer = bvh.get_layer(i)
        print('  layer %2d: %8d nodes, area = %e'
              % (i, len(layer), layer.area()))


def main(argv=None):
    parser = argparse.ArgumentParser('chroma-torch-bvh')
    sub = parser.add_subparsers(dest='command', required=True)

    p_create = sub.add_parser('create')
    p_create.add_argument('bvh_id', help='geo_name[:bvh_name]')
    p_create.add_argument('degree', type=int, nargs='?', default=3)

    p_stat = sub.add_parser('stat')
    p_stat.add_argument('bvh_id')

    p_list = sub.add_parser('list')
    p_list.add_argument('geo_name')

    p_remove = sub.add_parser('remove')
    p_remove.add_argument('bvh_id')

    p_opt = sub.add_parser('optimize', help='surface-area child '
                           'ordering (reference bin/chroma-bvh:51)')
    p_opt.add_argument('bvh_id')
    p_opt.add_argument('-o', dest='out_name', default=None,
                       help='output BVH name (default: overwrite)')

    args = parser.parse_args(argv)

    from chroma_tpu_torch.cache import Cache
    from chroma_tpu_torch.bvh import make_recursive_grid_bvh
    cache = Cache()

    if args.command == 'create':
        geo_name, bvh_name = parse_bvh_id(args.bvh_id)
        mesh_hash = cache.get_geometry_hash(geo_name)
        print('Loading geometry (MD5=%s): %s' % (mesh_hash, geo_name))
        geometry = cache.load_geometry(geo_name)
        print('Creating degree %d BVH...' % args.degree)
        start = time.time()
        bvh = make_recursive_grid_bvh(geometry.mesh,
                                      target_degree=args.degree)
        print('BVH generated in %1.1f seconds.' % (time.time() - start))
        cache.save_bvh(bvh, mesh_hash, bvh_name)
    elif args.command == 'stat':
        geo_name, bvh_name = parse_bvh_id(args.bvh_id)
        mesh_hash = cache.get_geometry_hash(geo_name)
        print_stat(geo_name, bvh_name, mesh_hash,
                   cache.load_bvh(mesh_hash, bvh_name))
    elif args.command == 'list':
        mesh_hash = cache.get_geometry_hash(args.geo_name)
        print('BVHs for %s (MD5=%s):' % (args.geo_name, mesh_hash))
        print('\n'.join(cache.list_bvh(mesh_hash)))
    elif args.command == 'remove':
        geo_name, bvh_name = parse_bvh_id(args.bvh_id)
        mesh_hash = cache.get_geometry_hash(geo_name)
        cache.remove_bvh(mesh_hash, bvh_name)
    elif args.command == 'optimize':
        from chroma_tpu_torch.bvh.optimize import area_sort_children, \
            layer_area
        geo_name, bvh_name = parse_bvh_id(args.bvh_id)
        mesh_hash = cache.get_geometry_hash(geo_name)
        bvh = cache.load_bvh(mesh_hash, bvh_name)
        before = layer_area(bvh.nodes)
        start = time.time()
        bvh = area_sort_children(bvh)
        print('optimized in %1.1f s (area unchanged by ordering: '
              '%1.3e)' % (time.time() - start, before))
        cache.save_bvh(bvh, mesh_hash, args.out_name or bvh_name)


if __name__ == '__main__':
    main()
